"""The port runs without JAX: importing it loads no jax, and chip_smoke.py
refuses to report a result on a machine without a CUDA device."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "handsonvlm_torch",
    "handsonvlm_torch.config",
    "handsonvlm_torch.ops._build",
    "handsonvlm_torch.ops.attention",
    "handsonvlm_torch.ops.decode_attention",
    "handsonvlm_torch.ops.vit_attention",
    "handsonvlm_torch.models.handsonvlm",
    "handsonvlm_torch.convert.from_hf",
    "handsonvlm_torch.infer.builder",
    "handsonvlm_torch.infer.sampler",
    "handsonvlm_torch.infer.chat",
    "chip_smoke",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n")
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
            "video, frame_map = cs._frames(cfg)\n"
            "conv = cs.new_conversation()\n"
            "gen = torch.Generator().manual_seed(0)\n"
            "out = cs.chat_turn(model, cfg, tok, conv, 'What is the person doing?', video,\n"
            "                   frame_map, gen, max_new_tokens=4, temperature=0.5, top_p=0.9)\n"
            "assert int(out.num_tokens[0]) >= 1\n"
            "ids = cs.prompt_ids(conv, tok, 'Predict the future trajectory of the hands.')\n"
            "assert int((ids == cfg.image_token_index).sum()) == 1, ids\n"
            "cs.phase_kernel_vs_plain(model, cfg, tok, video, frame_map)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "phase 4" in proc.stdout


def test_chip_smoke_fails_without_cuda():
    code = ("import torch, sys, runpy\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
