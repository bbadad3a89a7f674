"""HandsOnVLM in PyTorch for one NVIDIA H100 (Hopper, sm_90a).

The port of `handsonvlm_tpu` (JAX/Pallas), which stays in the repository as
the reference it is tested against. Module names mirror the JAX package:
`config`, `ops/*` (attention and the hand-written CUDA kernels under
`csrc/`), `models/*`, `infer/*` and `convert/*`. The framework-free modules
of `handsonvlm_tpu` (constants, data/, eval/traj_metrics, infer/viz,
convert/jax_to_hf) are imported rather than copied. This package never
imports jax.
"""
