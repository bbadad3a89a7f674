"""The port runs without JAX and without the JAX package: importing it,
and running chip_smoke's phases that a CPU can run, loads no `jax` and no
`handsonvlm_tpu` module (the EK data path loads no pandas either, and
builds its native readers under build/, not in the package);
chip_smoke.py refuses to report a result on a machine without a CUDA
device."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "handsonvlm_torch",
    "handsonvlm_torch.config",
    "handsonvlm_torch.constants",
    "handsonvlm_torch.data.conversation",
    "handsonvlm_torch.data.mock_tokenizer",
    "handsonvlm_torch.data.spm_model",
    "handsonvlm_torch.data.tokenization",
    "handsonvlm_torch.data.video_io",
    "handsonvlm_torch.ops._build",
    "handsonvlm_torch.ops.attention",
    "handsonvlm_torch.ops.cache_ops",
    "handsonvlm_torch.ops.decode_attention",
    "handsonvlm_torch.ops.flash_attention",
    "handsonvlm_torch.ops.int8_matmul",
    "handsonvlm_torch.ops.vit_attention",
    "handsonvlm_torch.models.llama",
    "handsonvlm_torch.models.lora",
    "handsonvlm_torch.models.handsonvlm",
    "handsonvlm_torch.convert.from_hf",
    "handsonvlm_torch.infer.builder",
    "handsonvlm_torch.infer.sampler",
    "handsonvlm_torch.infer.speculative",
    "handsonvlm_torch.infer.chat",
    "handsonvlm_torch.infer.profile",
    "handsonvlm_torch.infer.viz",
    "handsonvlm_torch.serve.continuous",
    "handsonvlm_torch.serve.scheduler",
    "handsonvlm_torch.serve.controller",
    "handsonvlm_torch.serve.lora_registry",
    "handsonvlm_torch.serve.batcher",
    "handsonvlm_torch.serve.model_worker",
    "handsonvlm_torch.serve.web_server",
    "handsonvlm_torch.serve.register_worker",
    "handsonvlm_torch.serve.test_message",
    "handsonvlm_torch.data.draws",
    "handsonvlm_torch.eval.traj_metrics",
    "handsonvlm_torch.eval.evaluator",
    "handsonvlm_torch.train.train_state",
    "handsonvlm_torch.train.step",
    "handsonvlm_torch.train.loader",
    "handsonvlm_torch.train.train",
    "handsonvlm_torch.core.checkpoint",
    "handsonvlm_torch.data.synthetic",
    "handsonvlm_torch.data.hybrid_dataset",
    "handsonvlm_torch.ops.qlora_fused",
    "handsonvlm_torch.ops.fused_decode",
    "handsonvlm_torch.utils.metrics_writer",
    "handsonvlm_torch.data.epic_constants",
    "handsonvlm_torch.data.epic_utils",
    "handsonvlm_torch.data.action_sampler",
    "handsonvlm_torch.data.native_build",
    "handsonvlm_torch.data.native_lmdb",
    "handsonvlm_torch.data.native_loader",
    "handsonvlm_torch.data.annotation",
    "handsonvlm_torch.data.epic_structures",
    "handsonvlm_torch.data.epic_dataset",
    "handsonvlm_torch.data.lita_datasets",
    "handsonvlm_torch.eval.evaluate",
    "handsonvlm_torch.eval.rtl",
    "handsonvlm_torch.eval.rtl_cli",
    "handsonvlm_torch.models.visual_tokens",
    "handsonvlm_torch.models.object_transformer",
    "handsonvlm_torch.models.lita_hoi",
    "handsonvlm_torch.convert.object_transformer",
    "handsonvlm_torch.train.hoi_trainer",
    "handsonvlm_torch.train.hoi_train",
    "handsonvlm_torch.utils.meters",
    "handsonvlm_torch.utils.logging",
    "handsonvlm_torch.utils.profiling",
    "handsonvlm_torch.eval.gpt_review",
    "handsonvlm_torch.convert.delta",
    "handsonvlm_torch.convert.to_hf",
    "handsonvlm_torch.parallel.distributed",
    "handsonvlm_torch.parallel.mesh",
    "handsonvlm_torch.parallel.partition",
    "handsonvlm_torch.parallel.ring_attention",
    "handsonvlm_torch.parallel.tp",
    "handsonvlm_torch.parallel.dryrun",
    "chip_smoke",
]
# modules the port must never load: JAX and the JAX package
FORBIDDEN = ("import sys\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'handsonvlm_tpu'))\n"
             "assert not bad, bad\n")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    code = ("import importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_phases_run_without_jax():
    """chip_smoke's prompt building, a chat turn and the kernel-vs-plain
    phase run at the tiny preset (bf16, CPU tensors take the plain
    versions) and load no jax on the way."""
    code = ("import sys, torch\n"
            "import chip_smoke as cs\n"
            "model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu')\n"
            "model.to(torch.bfloat16)\n"
            "video, frame_map = cs.random_video(cfg)\n"
            "conv = cs.new_conversation()\n"
            "gen = torch.Generator().manual_seed(0)\n"
            "out = cs.chat_turn(model, cfg, tok, conv, 'What is the person doing?', video,\n"
            "                   frame_map, gen, max_new_tokens=4, temperature=0.5, top_p=0.9)\n"
            "assert int(out.num_tokens[0]) >= 1\n"
            "ids = cs.prompt_ids(conv, tok, 'Predict the future trajectory of the hands.')\n"
            "assert int((ids == cfg.image_token_index).sum()) == 1, ids\n"
            "h, toks, _ = cs.phase_kernel_vs_plain(model, cfg, tok, video, frame_map)\n"
            "print('phase 4 ran', toks)\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phase 4 ran" in proc.stdout


def test_chip_smoke_quantized_phases_run_without_jax():
    """chip_smoke's int4 + int8-cache chat phase and its quantized
    kernel-vs-plain phase run at the tiny preset (bf16 activations, CPU
    tensors take the plain versions) and load neither jax nor the JAX
    package on the way."""
    code = ("import torch\n"
            "import chip_smoke as cs\n"
            "model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu',\n"
            "                                           quantize='int4')\n"
            "for p in model.parameters():\n"
            "    p.data = p.data.to(torch.bfloat16)\n"
            "video, frame_map = cs.random_video(cfg)\n"
            "run = cs.phase_chat(model, cfg, tok, video, frame_map, kv_quant='int8',\n"
            "                    new_tokens=4)\n"
            "assert run['prefills'] == 3 and run['decode_steps'] >= 3, run\n"
            "assert not any(run['launches'].values()), run  # no kernel on the CPU\n"
            "cs.phase_quant_kernel_vs_plain(model, cfg, tok, video, frame_map)\n"
            "print('phase 6 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phase 6 ran" in proc.stdout


def test_chip_smoke_serving_phases_run_without_jax():
    """chip_smoke's compaction phase (bit-equal stream across a compaction,
    int4 + int8 cache) and its EK100 evaluation phase (serial, batched, a
    staggered burst that compacts, the greedy first-token check) run at the
    tiny preset on the CPU (plain versions, no launches) and load neither
    jax nor the JAX package."""
    code = ("import torch\n"
            "import chip_smoke as cs\n"
            "model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu',\n"
            "                                           quantize='int4')\n"
            "for p in model.parameters():\n"
            "    p.data = p.data.to(torch.bfloat16)\n"
            "times = cs.phase_compaction(model, cfg, kv_quant='int8', prompt_len=120)\n"
            "assert times['compact_ms'] > 0, times\n"
            "st = cs.phase_eval(model, cfg, tok, n_clips=4, serial_clips=2, max_new=6, slots=2,\n"
            "                   max_len=1024, chunk=4, burst=9, burst_slots=2, burst_len=384,\n"
            "                   burst_chunk=4, burst_gap_s=0.01)\n"
            "assert st['batched_tok_s'] > 0 and st['ttft_p95_ms'] > 0, st\n"
            "assert not any(st['launches'].values()), st  # no kernel on the CPU\n"
            "print('phases 7-8 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phases 7-8 ran" in proc.stdout


def test_chip_smoke_long_prompt_and_spec_phases_run_without_jax():
    """chip_smoke's long-prompt phase, its speculative phase (run A, run B
    with run A's stream as the bank, the cache-index trace, a verify window
    against single steps, the sampled run with the gate on) and the
    kernel-vs-plain phases at the long prompt (with the steps under
    attn_impl="decode") run at the tiny preset on the CPU, dense bf16 and
    int4 + int8 cache, and load neither jax nor the JAX package."""
    code = ("import torch\n"
            "import chip_smoke as cs\n"
            "for quantize, kvq in ((None, None), ('int4', 'int8')):\n"
            "    model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu',\n"
            "                                               quantize=quantize)\n"
            "    for p in model.parameters():\n"
            "        p.data = p.data.to(torch.bfloat16)\n"
            "    video, frame_map = cs.random_video(cfg)\n"
            "    text, counts = cs.phase_long_prompt(model, cfg, tok, video, frame_map,\n"
            "                                        kv_quant=kvq, rows=120, new_tokens=4)\n"
            "    assert not any(counts.values()), counts  # no kernel on the CPU\n"
            "    cs.phase_spec(model, cfg, tok, video, frame_map, kv_quant=kvq, new_tokens=8)\n"
            "    if quantize:\n"
            "        cs.phase_quant_kernel_vs_plain(model, cfg, tok, video, frame_map,\n"
            "                                       long_text=text)\n"
            "    else:\n"
            "        h, toks, b12 = cs.phase_kernel_vs_plain(model, cfg, tok, video, frame_map,\n"
            "                                                long_text=text)\n"
            "        assert b12 == 0  # the count read in the run: no kernel on the CPU\n"
            "print('phases 9-10 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phases 9-10 ran" in proc.stdout and "run B (bank" in proc.stdout


def test_chip_smoke_int8_and_flat_int4_phases_run_without_jax():
    """chip_smoke's phases 11-13 at the tiny preset on the CPU (bf16
    activations, plain versions, no launches): the int8 chat turns, the
    int8 speculative phase with the window's rows bit-equal to single
    steps, the batched int8 evaluation, the int8 kernel-vs-plain phase, the
    fused flat int4 layout bit-equal to the tiled one, and phase 6 over the
    tiled and the per-projection flat layouts; jax and the JAX package stay
    unloaded."""
    code = ("import torch\n"
            "import chip_smoke as cs\n"
            "def load(q):\n"
            "    model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu',\n"
            "                                               quantize=q)\n"
            "    for p in model.parameters():\n"
            "        p.data = p.data.to(torch.bfloat16)\n"
            "    return model, cfg, tok\n"
            "model, cfg, tok = load('int8')\n"
            "video, frame_map = cs.random_video(cfg)\n"
            "run = cs.phase_chat(model, cfg, tok, video, frame_map, new_tokens=4)\n"
            "assert run['prefills'] == 3 and not any(run['launches'].values()), run\n"
            "assert cs.serving_launches(model, cfg, None, 5, 1, 0)['int8_matmul'] == 7 * 2 * 6\n"
            "cs.phase_spec(model, cfg, tok, video, frame_map, kv_quant='int8', new_tokens=8,\n"
            "              window_exact=True)\n"
            "st = cs.phase_eval_batched(model, cfg, tok, n_clips=3, slots=2, chunk=4, max_new=6,\n"
            "                           max_len=1024)\n"
            "assert st['batched_tok_s'] > 0, st\n"
            "cs.phase_kernel_vs_plain(model, cfg, tok, video, frame_map)\n"
            "model, cfg, tok = load('int4')\n"
            "counts, proj = cs.phase_flat_int4(model, cfg, tok, video, frame_map)\n"
            "assert sorted(proj) == sorted(cs.projection_shapes(cfg.llama)), sorted(proj)\n"
            "counts = cs.phase_quant_kernel_vs_plain(\n"
            "    model, cfg, tok, video, frame_map,\n"
            "    layouts={'tiled': (model.llama.int4, None), 'flat': (None, proj)})\n"
            "assert sorted(counts) == ['flat', 'tiled'], counts\n"
            "print('phases 11-13 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phases 11-13 ran" in proc.stdout and "bit-equal: ok" in proc.stdout


def test_chip_smoke_train_phases_run_without_jax():
    """chip_smoke's phase 14 at the tiny preset on the CPU (fp32, plain
    versions, no launches): LoRA steps over the dense base, the gradient
    check, QLoRA int4 tiled and flat and QLoRA int8 steps through the
    port's train step, each base bit-identical and the adapters moved; jax
    and the JAX package stay unloaded."""
    code = ("import chip_smoke as cs\n"
            "model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu')\n"
            "counts = cs.phase_train(model, cfg, rows=140, r=2, alpha=4.0, steps=2)\n"
            "assert sorted(counts) == ['flash_attention', 'flash_attention_bwd',\n"
            "                          'int4_matmul_T_flat', 'int4_matmul_T_tiled'], counts\n"
            "assert model.lora is None and not any(p.requires_grad for p in model.parameters())\n"
            "model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu',\n"
            "                                           quantize='int8')\n"
            "cs.phase_train_int8(model, cfg, rows=140, r=2, alpha=4.0)\n"
            "print('phase 14 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phase 14 ran" in proc.stdout and "FAIL" not in proc.stdout
    assert proc.stdout.count("bit-identical after the steps: ok") == 4


def test_chip_smoke_fused_qlora_and_cli_phases_run_without_jax():
    """chip_smoke's phase 14f (QLoRA int8_fused steps over the int8 model's
    weights, after 14d, and the gradient check 14e-int8-fused) and phase 15
    (the training CLI: two steps, the checkpoint restored bit-equal, a
    resumed run in its own process, the LoRA artifact merged by the builder
    answering a chat turn) at the tiny preset on the CPU, jax-free."""
    code = ("import chip_smoke as cs\n"
            "model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu',\n"
            "                                           quantize='int8')\n"
            "stats = cs.phase_train_int8(model, cfg, rows=140, r=2, alpha=4.0)\n"
            "counts = cs.phase_train_int8_fused(model, cfg, stats, rows=140, r=2, alpha=4.0,\n"
            "                                   steps=2)\n"
            "assert sorted(counts) == ['int8_stacked_bwd', 'int8_stacked_fwd'], counts\n"
            "assert model.llama.quantize == 'int8' and model.lora is None\n"
            "cs.phase_cli(device='cpu', preset='tiny', r=2)\n"
            "print('phases 14f and 15 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "phases 14f and 15 ran" in out and "FAIL" not in out
    assert "14f int8 weights bit-identical after the steps: ok" in out
    assert "resumed from step 2" in out and "bit-equal to the saved state" in out


def test_profile_cli_train_int8_fused_rehearses_on_cpu():
    """The profiler's CLI with `--train --quantize int8_fused` at the tiny
    preset on the CPU, jax-free."""
    code = ("import json, sys, runpy, io, contextlib\n"
            "sys.argv = ['profile', '--preset', 'tiny', '--device', 'cpu', '--quantize',\n"
            "            'int8_fused', '--train', '--prompt-rows', '140']\n"
            "out = io.StringIO()\n"
            "with contextlib.redirect_stdout(out):\n"
            "    runpy.run_module('handsonvlm_torch.infer.profile', run_name='__main__')\n"
            "res = json.loads(out.getvalue().strip().splitlines()[-1])\n"
            "assert res['quantize'] == 'int8_fused' and res['train_step']['wall_ms'] > 0, res\n"
            + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_profile_cli_rehearses_on_cpu():
    """The profiler's CLI runs its control flow at the tiny preset on the
    CPU, reports no device numbers there, and loads no jax."""
    code = ("import json, sys, runpy, io, contextlib\n"
            "sys.argv = ['profile', '--preset', 'tiny', '--device', 'cpu', '--quantize',\n"
            "            'int4', '--kv-int8', '--steps', '2', '--spec', '3',\n"
            "            '--prompt-rows', '70']\n"
            "out = io.StringIO()\n"
            "with contextlib.redirect_stdout(out):\n"
            "    runpy.run_module('handsonvlm_torch.infer.profile', run_name='__main__')\n"
            "res = json.loads(out.getvalue().strip().splitlines()[-1])\n"
            "assert res['decode_step']['device_ms'] is None, res\n"
            "assert res['prefill']['wall_ms'] > 0, res\n"
            "assert res['verify_forward']['wall_ms'] > 0, res\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_profile_cli_int8_rehearses_on_cpu():
    """The profiler's CLI with `--quantize int8` at the tiny preset on the
    CPU, jax-free."""
    code = ("import json, sys, runpy, io, contextlib\n"
            "sys.argv = ['profile', '--preset', 'tiny', '--device', 'cpu', '--quantize',\n"
            "            'int8', '--steps', '2']\n"
            "out = io.StringIO()\n"
            "with contextlib.redirect_stdout(out):\n"
            "    runpy.run_module('handsonvlm_torch.infer.profile', run_name='__main__')\n"
            "res = json.loads(out.getvalue().strip().splitlines()[-1])\n"
            "assert res['quantize'] == 'int8' and res['decode_step']['wall_ms'] > 0, res\n"
            + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_profile_cli_train_rehearses_on_cpu():
    """The profiler's CLI with `--train` (a QLoRA int4 step) at the tiny
    preset on the CPU, jax-free."""
    code = ("import json, sys, runpy, io, contextlib\n"
            "sys.argv = ['profile', '--preset', 'tiny', '--device', 'cpu', '--quantize',\n"
            "            'int4', '--train', '--prompt-rows', '140']\n"
            "out = io.StringIO()\n"
            "with contextlib.redirect_stdout(out):\n"
            "    runpy.run_module('handsonvlm_torch.infer.profile', run_name='__main__')\n"
            "res = json.loads(out.getvalue().strip().splitlines()[-1])\n"
            "assert res['rows'] == 140 and res['train_step']['wall_ms'] > 0, res\n"
            + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_eval_cli_phase_runs_without_jax():
    """chip_smoke's phase 16 at tiny224 on the CPU: the EK100 layout written
    with the stdlib and PIL, the eval CLI's main() in bf16 serial, int4 +
    kv8 reasoning batched and speculative, each run's summary, clips and
    (zero) launches checked, the native frame loader's counter read; the
    native LMDB reader and frame loader built
    into build/, nothing built beside the package's sources; neither jax,
    the JAX package nor pandas loaded."""
    code = ("import glob, os, sys\n"
            "import chip_smoke as cs\n"
            "from handsonvlm_torch.data import native_loader\n"
            "runs = cs.phase_ek_cli(device='cpu', preset='tiny224', max_new=4, slots=2,\n"
            "                       spec_k=2)\n"
            "assert len(runs) == 3 and all(r['tokens'] > 0 for r in runs.values()), runs\n"
            "assert not any(any(r['launches'].values()) for r in runs.values())\n"
            "native_loader.native_available()\n"
            "so = glob.glob('handsonvlm_torch/**/*.so', recursive=True)\n"
            "assert not so, so\n"
            "assert 'pandas' not in sys.modules\n"
            "print('phase 16 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phase 16 ran" in proc.stdout and "frame route: JPEGs written and decoded" in proc.stdout
    assert "16 native frame loader on 10 frames: decoded by" in proc.stdout
    assert proc.stdout.count("0 truncated") == 3


def test_chip_smoke_serving_stack_phase_runs_without_jax():
    """chip_smoke's phase 17 at tiny on the CPU: the controller, the bf16
    worker (continuous batching, speculative decode, two LoRA adapters with
    one resident), a burst, a stream, the web proxy, test_message, the
    adapter requests, then the int4 + kv8 worker's dynamic batcher, every
    check of the phase run (launches are 0 off the card); neither jax nor
    the JAX package loaded."""
    code = ("import chip_smoke as cs\n"
            "st = cs.phase_serving(device='cpu', preset='tiny', new_tokens=6, spec_k=2,\n"
            "                      lora_r=4, b_std=0.5)\n"
            "assert st['a']['tokens'] == 48 and st['b']['batches'] < 4, st\n"
            "print('phase 17 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phase 17 ran" in proc.stdout
    assert "17a base model lora after the adapter requests: None; adapter evictions 1" in (
        proc.stdout)


def test_chip_smoke_hoi_phases_run_without_jax():
    """chip_smoke's phase 18 at tiny on the CPU in bf16: 18b (LITA-HOI over
    the model's decoder: B3 / B3b at the path's shape against their plain
    versions, the loss, backward, hidden states and rollout on the plain
    and flash routes) and 18c (the origin pipeline), then phase 4, which
    leaves the model in fp32 under inference_mode, and 18b/c's fp32
    reference with phase 4's rule; 18a, the hoi_train CLI at tiny widths
    over the EK100 fixture, two epochs and a resumed run. Neither jax nor
    the JAX package loaded."""
    code = ("import torch\n"
            "import chip_smoke as cs\n"
            "model, cfg, tok = cs.load_pretrained_model('random:tiny', 'tiny', 'cpu')\n"
            "model.to(torch.bfloat16)\n"
            "video, frame_map = cs.random_video(cfg)\n"
            "hoi = cs.phase_hoi_7b(model, cfg)\n"
            "cs.phase_kernel_vs_plain(model, cfg, tok, video, frame_map)\n"
            "cs.phase_hoi_7b_reference(model, hoi)\n"
            "cs.phase_hoi_cli(device='cpu', extra=['--embed-dim', '32', '--coord-dim', '8',\n"
            "    '--num-heads', '4', '--enc-depth', '1', '--dec-depth', '1', '--hidden-dim',\n"
            "    '16', '--latent-dim', '8', '--batch-size', '8', '--num-samples', '2'])\n"
            "print('phase 18 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phase 18 ran" in proc.stdout
    for line in ("18b grads relative L2 from the fp32 plain route",
                 "18c tokens relative L2 from the fp32 plain route",
                 "18a checkpoints at steps [1, 2, 3, 4]"):
        assert line in proc.stdout, line


def test_chip_smoke_parallel_phase_runs_without_jax():
    """chip_smoke's phase 19b at tiny on the CPU over 2 gloo ranks (the
    tensor-parallel decode in bf16 and int4 + kv8 against the unsharded
    run and its fp32 reference, the FSDP2 full-SFT steps, the ring step
    against the one-card route; 4 new tokens where the card decodes 32;
    tensor parallelism inside training at (1, 2) in every mode against the
    one-card step, and the train CLI with --model-axis 2 resumed in one
    rank; 19c at tiny224: the sharded evaluation of the steered model
    against one rank's of the gathered state at (2, 1) and (1, 2), the
    planted wrong slice the rule refuses, the steps around it, the CLI
    with --eval-every under torchrun), then the dry run over 2 ranks, both
    kinds. Neither jax nor the
    JAX package loaded in the parent; each rank imports chip_smoke and the
    port alone."""
    code = ("import chip_smoke as cs\n"
            "from handsonvlm_torch.parallel import dryrun\n"
            "cs.phase_parallel(device='cpu', preset='tiny', ranks=2, rows=96, new_tokens=4)\n"
            "line = dryrun.dryrun(2, 'cpu')\n"
            "line = dryrun.dryrun(2, 'cpu', 'tp-train')\n"
            "print('phase 19 ran')\n" + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phase 19 ran" in proc.stdout
    for line in ("19b bf16 tp=2: heads split True", "19b int4 + kv8: final hidden relative L2",
                 "19b FSDP step 1: loss", "19b FSDP step 0 against one card's",
                 "19b FSDP checkpoint gather", "19b adapter gradients",
                 "dryrun_multichip ok: mesh=(2,1)", "tp_decode_tokens=4",
                 "19b TP sft 1x2 step 0 against one card's", "19b TP int8_fused 1x2 step 1",
                 "19b CLI resumed on one rank: resumed from step 2",
                 "19c int8_fused 2x1 against one card's evaluation of the whole state: n 4 / 4",
                 "19c sft 1x2 against one card's evaluation of the whole state: n 4 / 4",
                 "19c sft 1x2 step 1 (after the evaluation) against one card's",
                 "19c sft 1x2 planted fault (rank 1 on rank 0's slices) against one card's",
                 "--eval-every 1 --eval-samples 4: exit 0",
                 "dryrun_multichip tp-train ok: mesh=(1, 2)"):
        assert line in proc.stdout, line


def test_chip_smoke_fails_without_cuda():
    code = ("import torch, sys, runpy\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
