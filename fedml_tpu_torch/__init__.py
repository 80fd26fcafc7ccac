"""fedml_tpu_torch — the PyTorch/CUDA port of fedml_tpu.

The JAX package ``fedml_tpu`` is the reference; this package re-implements
its main path in PyTorch for an NVIDIA H100: seeded client sampling, the
host cohort gather, per-client local SGD, and the defended FedAvg
aggregate, whose fused clip + noise + mean runs as a hand-written CUDA
kernel (``csrc/robust_agg.cu``).

Parameters travel as flat ``dict``s of tensors keyed by the flax path
(``"Conv_0/kernel"``), in the JAX layout (conv kernels HWIO, dense kernels
``[in, out]``) and in JAX's leaf order, so weights carry across the two
packages by renaming alone (``utils/jax_params.py``).

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--platform cpu`` / ``device="cpu"``); with no GPU they raise.
"""
