"""Package rules of flingbot_tpu_torch: it never imports JAX or the JAX
package, its entry points refuse to run without CUDA unless asked for the
CPU, and its kernel wrappers take the plain version only for CPU
tensors."""

import os
import subprocess
import sys

import pytest
import torch

from flingbot_tpu_torch import resolve_device
from flingbot_tpu_torch.engine import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the single-env surface and the report tools, and the last modules
# (parallelism, the profiler, offline training, the native runtime, the
# real-world stack), which the walk must reach
NEW_MODULES = ("flingbot_tpu_torch.env.sim_env",
               "flingbot_tpu_torch.pyflex_compat",
               "flingbot_tpu_torch.utils.vis",
               "flingbot_tpu_torch.visualize",
               "flingbot_tpu_torch.parallel.mesh",
               "flingbot_tpu_torch.parallel.dryrun",
               "flingbot_tpu_torch.utils.profiling",
               "flingbot_tpu_torch.offline_train",
               "flingbot_tpu_torch.native",
               "flingbot_tpu_torch.env.exceptions",
               "flingbot_tpu_torch.real_world.real_world_env",
               "flingbot_tpu_torch.real_world.fakes",
               "flingbot_tpu_torch.run_real_world",
               "flingbot_tpu_torch.calibrate_camera")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flingbot_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'flingbot_tpu' or m.startswith('flingbot_tpu.')]\n"
        "assert not bad, bad\n"
        "missing = [m for m in NEW if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('flingbot_tpu_torch')]))\n")
    code = f"NEW = {NEW_MODULES!r}\n" + code
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    from flingbot_tpu_torch import pyflex_compat
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.sim_env import SimEnv
    with pytest.raises(RuntimeError):
        BatchSimEnv()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimEnv(get_task_fn=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pyflex_compat.init()
    from flingbot_tpu_torch.engine.topology import build_grid_topology
    from flingbot_tpu_torch.env.scene import flat_tasks, make_batch
    from flingbot_tpu_torch.render.rasterizer import (
        domain_randomized_palette)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_batch(flat_tasks([(16, 16)]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_grid_topology(16, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        domain_randomized_palette(torch.Generator().manual_seed(0), 1, 8)
    # the last modules' entry points
    from flingbot_tpu_torch import (
        calibrate_camera, offline_train, run_real_world)
    from flingbot_tpu_torch.parallel import dryrun, mesh
    from flingbot_tpu_torch.real_world import RealWorldEnv
    from flingbot_tpu_torch.utils import profiling
    for call in (profiling.profile_solver_stages,
                 lambda: offline_train.main(["--log", "unused"]),
                 RealWorldEnv,
                 lambda: run_real_world.main([]),
                 lambda: calibrate_camera.main([]),
                 lambda: dryrun.dryrun_multichip(1),
                 lambda: dryrun.main(["--ranks", "1"]),
                 mesh.init_distributed):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"
    topo, state = make_batch(flat_tasks([(16, 16)]), max_grid_dim=16,
                             device="cpu")
    assert state.positions.device.type == "cpu"
    assert topo.dimx.device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_wrappers_use_plain_versions_only_on_cpu():
    before = dict(kernels.LAUNCHES)
    B, H, W = 1, 4, 4
    pvec = torch.zeros(B, kernels.SUB_PARAM_LEN)
    pvec[:, 0] = 0.0025
    pvec[:, 10] = W
    pvec[:, 11] = H
    P = torch.zeros(B, 3, H, W)
    out = kernels.substeps(pvec, P, P, torch.ones(B, H, W), n_sub=1,
                           iterations=2)
    assert all(o.shape == P.shape for o in out)
    assert kernels.LAUNCHES == before  # plain versions do not count
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels._check(P.to("meta"), "P", P.shape)
