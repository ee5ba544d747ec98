"""flingbot_tpu_torch: the PyTorch/CUDA port of flingbot_tpu.

The package mirrors the layout of `flingbot_tpu` (engine/, env/, render/,
learning/, utils/) and runs `run_sim.py`'s loop on an NVIDIA Hopper card:
`BatchSimEnv.reset` -> `MaximumValuePolicy.batch_value_maps` ->
`BatchSimEnv.step`, then training of the value net on the replay record
(`python -m flingbot_tpu_torch.run_sim`; `eval_quality` and `bench` are
the other entry points).  The two Pallas kernels of the JAX package are CUDA
kernels here (`csrc/substeps.cu`, `csrc/contacts.cu`), built with `nvcc`
at first use and bound with `ctypes` (engine/kernels.py).

Hot arrays are batched and component-leading: cloth state is kept in
LATTICE order, positions (B, 3, H*W) with slot index y * W + x, so the
physics step never converts layouts (the JAX package converts canonical
(N, 3) state to a (3, H, W) lattice and back every step); generic meshes
keep vertex order, (B, 3, N).

Every solver mode of the JAX package is here: the pallas backend (the
kernels) and the xla backend (plain PyTorch, launching no kernel) with
every spring mode and contact mode, on grid cloths, layered shirts and
generic meshes, and both task generators.  One flag is still refused:
--dump_visualizations (ROADMAP Queue 1 item 7).

Entry points run on the card (`device="cuda"`) and raise when CUDA is
absent; they run on the CPU only when the caller passes `device="cpu"`.
"""

from flingbot_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
