"""flingbot_tpu_torch: the PyTorch/CUDA port of flingbot_tpu.

The package mirrors the layout of `flingbot_tpu` (engine/, env/, render/,
learning/) and runs the eval main path of `run_sim.py` on an NVIDIA Hopper
card: `BatchSimEnv.reset` -> `MaximumValuePolicy.batch_value_maps` ->
`BatchSimEnv.step`.  The two Pallas kernels of the JAX package are CUDA
kernels here (`csrc/substeps.cu`, `csrc/contacts.cu`), built with `nvcc`
at first use and bound with `ctypes` (engine/kernels.py).

Hot arrays are batched and component-leading: cloth state is kept in
LATTICE order, positions (B, 3, H*W) with slot index y * W + x, so the
physics step never converts layouts (the JAX package converts canonical
(N, 3) state to a (3, H, W) lattice and back every step).

Entry points run on the card (`device="cuda"`) and raise when CUDA is
absent; they run on the CPU only when the caller passes `device="cpu"`.
"""

from flingbot_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
