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
generic meshes, and both task generators; every run_sim flag, the episode
videos of --dump_visualizations included.  Beside the batched env are the
single-env surface (`env.sim_env.SimEnv`, `pyflex_compat`) and the replay
gallery (`python -m flingbot_tpu_torch.visualize`); data parallelism over
torch.distributed (`parallel/`, one process per card), the solver-stage
profiler (`utils/profiling.py`), offline training (`offline_train`), the
g++-built host runtime (`native/`) and the dual-UR5 real-world stack
(`real_world/`, `run_real_world`, `calibrate_camera`).

Entry points run on the card (`device="cuda"`) and raise when CUDA is
absent; they run on the CPU only when the caller passes `device="cpu"`.
"""

from flingbot_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
