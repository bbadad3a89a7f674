"""HandsOnVLM in PyTorch for one NVIDIA H100 (Hopper, sm_90a).

The port of `handsonvlm_tpu` (JAX/Pallas), which stays in the repository as
the reference it is tested against. Module names mirror the JAX package:
`config`, `constants`, `data/*`, `ops/*` (attention, the int4 / int8
quantizers and the hand-written CUDA kernels under `csrc/`), `models/*`,
`infer/*` and `convert/*`. This package imports neither jax nor
`handsonvlm_tpu`: the framework-free modules it needs from the JAX package
(constants, data/, infer/viz) are copied here, and only the tests import
both packages.
"""
