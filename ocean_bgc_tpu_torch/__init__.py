"""ocean_bgc_tpu_torch — the PyTorch/CUDA port of ``ocean_bgc_tpu``.

The same column physics (BGC + DMS + MACROS + co2calc + air-sea fluxes)
as plain functions on torch tensors, with the per-cell dual pH solve as a
hand-written CUDA kernel for Hopper (``csrc/carbonate_dual.cu``).  The
JAX package is the reference this port is held against; this package
imports none of it.

Entry points that create tensors (``utils.synthetic.synthetic_world``,
``utils.bridge.world_from_numpy``, ``io.model_io.load_world``,
``utils.checkpoint.restore``) and the model runner (``python -m
ocean_bgc_tpu_torch.run_model``) default to the CUDA device; pass
``device="cpu"`` (``--device cpu``) to run on the CPU, where each kernel's
plain PyTorch version stands in for it.
"""

__version__ = "0.1.0"
