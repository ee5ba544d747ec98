"""The port's eval entry point, python -m flingbot_tpu_torch.eval_quality:
its heuristic value maps against the numpy original of the root
eval_quality.py, a CPU run of the command on a tiny task file, the
checkpoint and test-time-averaging options refusing a missing companion
option, and (on a card) file tasks settled on the card
against the CPU plain path.

The card test needs neither jax nor h5py (a card's machine may have
neither): the other tests import them inside their bodies."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from flingbot_tpu_torch.eval_quality import heuristic_value_maps, main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARD = os.path.join(ROOT, "data_r3", "rect_eval_hard_100.npz")
# chip_smoke's card-vs-CPU frame gate: FRAME_TOL m, or NOISE_FACTOR times
# the CPU frame's own move under NOISE relative input noise
FRAME_TOL, NOISE, NOISE_FACTOR = 1e-4, 1e-7, 2.0


def numpy_heuristic():
    """heuristic_value_maps of the root eval_quality.py, taken from its
    source: importing that module would set JAX's compilation cache."""
    tree = ast.parse(open(os.path.join(ROOT, "eval_quality.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "heuristic_value_maps")
    ns = {"np": np}
    exec(compile(ast.Module([fn], []), "eval_quality.py", "exec"), ns)
    return ns["heuristic_value_maps"]


def test_heuristic_value_maps_match_numpy():
    rng = np.random.default_rng(0)
    B, T, D = 3, 8, 64
    obs = rng.uniform(0.0, 1.0, (B, T, 4, D, D)).astype(np.float32)
    depth = np.full((B, T, D, D), 2.0, np.float32)
    for b in range(B):
        for k in range(T - 1):  # the last view of each env: no cloth
            r0, c0 = rng.integers(0, D // 2, 2)
            h, w = rng.integers(4, D // 2, 2)
            depth[b, k, r0:r0 + h, c0:c0 + w] = rng.uniform(
                1.9, 1.9949, (h, w))
    depth[0, 0, 5, 5] = np.float32(1.995)  # the threshold itself
    obs[:, :, 3] = depth
    want = numpy_heuristic()(obs)
    got = heuristic_value_maps(torch.from_numpy(obs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    flat = lambda a: np.asarray(a).reshape(B, -1)  # noqa: E731
    np.testing.assert_array_equal(flat(got).argmax(1), flat(want).argmax(1))


def test_eval_quality_cli_on_cpu(tmp_path, capsys):
    from tests.test_torch_common import write_grid_tasks
    from tools.export_tasks_npz import export

    h5 = write_grid_tasks(str(tmp_path / "tasks.hdf5"), ((12, 10), (11, 12)),
                          np.random.default_rng(0))
    npz = str(tmp_path / "tasks.npz")
    export(h5, npz)
    stats = str(tmp_path / "stats.json")
    main(["--tasks", npz, "--device", "cpu", "--policy", "heuristic",
          "--steps", "1", "--num_envs", "2", "--max_grid_dim", "12",
          "--render_dim", "64", "--num_rotations", "2", "--scale_factors",
          "1.0", "--substeps", "2", "--iterations", "2",
          "--contact_iterations", "1", "--contact_window", "4",
          "--stats_out", stats])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["episodes"] == 2
    for k in ("init_coverage/hard/mean", "final_coverage/hard/mean",
              "best_coverage/hard/mean", "episode_delta_coverage/hard/max",
              "delta_coverage/hard/percent_positive"):
        assert k in last, k
    dist = json.load(open(stats))["best_coverage/hard/distribution"]
    assert len(dist) == 2


@pytest.mark.parametrize("flag,match", [
    (["--policy", "ckpt"], "checkpoint"), (["--tta"], "tta")])
def test_unported_options_raise(flag, match):
    """Both options are ported; each raises when its companion is
    missing: a checkpoint policy without --load, test-time averaging
    without a value net."""
    with pytest.raises(ValueError, match=match):
        main(["--tasks", HARD, "--device", "cpu"] + flag)


@pytest.mark.parametrize("mode", ["chunked", "fused"])
def test_exec_mode_is_accepted_and_ignored(mode):
    """--exec_mode takes both of the JAX eval_quality's values, as
    run_sim's config does (a TPU execution knob)."""
    from flingbot_tpu_torch.eval_quality import parse_args

    args = parse_args(["--tasks", HARD, "--exec_mode", mode])
    assert args.exec_mode == mode


def test_eval_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--tasks", HARD])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_file_tasks_settle_as_on_cpu(cuda_device):
    """4 tasks of the hard eval set: reset() on the card against reset()
    on the CPU plain path, then one heuristic fling step on the card.

    The settle frame of a crumpled file state is ill-conditioned for some
    envs: a last-place difference flips a contact or the velocity clamp.
    So each env is held to the larger of FRAME_TOL and NOISE_FACTOR times
    how far NOISE relative noise on its input positions moves the CPU
    frame (chip_smoke's frame_check gate); an env that the noise moves by
    less than FRAME_TOL must also match the CPU's init coverage to 6
    digits."""
    from flingbot_tpu_torch.engine.solver import step
    from flingbot_tpu_torch.env.batch_env import BatchSimEnv
    from flingbot_tpu_torch.env.coverage import get_current_covered_area
    from flingbot_tpu_torch.env.tasks import TaskLoader

    envs = []
    for dev in (cuda_device, "cpu"):
        loader = TaskLoader(HARD)
        envs.append(BatchSimEnv(get_task_fn=loader.get_next_task, num_envs=4,
                                episode_length=3, render_dim=256,
                                chunk_steps=192, device=dev))
        envs[-1].reset()
    card, cpu = envs
    topo, start = cpu.load_scenes(cpu.tasks)
    assert torch.equal(step(start, topo, cpu.params, **cpu.sim_kw).positions,
                       cpu.state.positions)
    spread = torch.zeros(4)
    for seed in (0, 1):
        P = start.positions
        noisy = P * (1 + NOISE * torch.randn(
            P.shape, generator=torch.Generator().manual_seed(seed)))
        moved = step(start.replace(positions=torch.where(
            start.active[:, None], noisy, P)), topo, cpu.params,
            **cpu.sim_kw).positions
        spread = torch.maximum(spread, (moved - cpu.state.positions).abs()
                               .amax((1, 2)))
    err = (card.state.positions.cpu() - cpu.state.positions).abs().amax(
        (1, 2))
    tol = torch.clamp(NOISE_FACTOR * spread, min=FRAME_TOL)
    assert bool((err <= tol).all()), (err, spread)
    calm = spread < FRAME_TOL
    assert bool(calm.any())
    torch.testing.assert_close(card.init_coverage.cpu()[calm],
                               cpu.init_coverage[calm], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(
        get_current_covered_area(card.state.positions, card.state.active)
        .cpu(), card.init_coverage.cpu(), rtol=0.0, atol=0.0)
    obs = card.step(heuristic_value_maps(card.obs.obs_stack))
    assert bool(torch.isfinite(obs).all())
    assert card.timesteps.tolist() == [
        0 if t else 1 for t in card.last.terminate.tolist()]
