"""Flags of the port's run_sim (counterpart of
flingbot_tpu/utils/config.py): the same training, eval and env flags with
the same defaults, plus --device.

A flag whose results the port cannot reproduce raises
NotImplementedError in apply_presets when set to anything but its
default, naming the ROADMAP item that ports it: only
--dump_visualizations (the episode videos) is left.  --backend xla runs
the plain PyTorch counterpart of the JAX package's kernel-free backend,
with every --contact_mode.  The JAX package's TPU execution knobs
(--exec_mode, --chunk_loop, --env_chunk, --obs_chunk, --dp_devices) do
not change results; they are accepted and ignored.
"""

from __future__ import annotations

import json
import random
from argparse import ArgumentParser, BooleanOptionalAction

import numpy as np
import torch

from flingbot_tpu_torch.engine.state import FLEX_SCENE_FRICTION, SolverParams

_IGNORED = ("accepted and ignored by the port: a TPU execution knob of the "
            "JAX package that does not change results")


def config_parser(parser: ArgumentParser = None) -> ArgumentParser:
    if parser is None:
        parser = ArgumentParser("Dynamic Cloth Manipulation (PyTorch/CUDA)")
    parser.add_argument("--log", type=str, default="runs/default")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--load", type=str, default=None,
                        help="policy checkpoint to load: a .pth of the "
                             "port, or a JAX checkpoint exported to .npz "
                             "by tools/export_ckpt_npz.py")
    parser.add_argument("--num_envs", type=int, default=16,
                        help="envs stepped in lockstep (replaces "
                             "num_processes)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="alias of --num_envs (reference flag name)")
    parser.add_argument("--tasks", type=str, default="tasks.npz",
                        help="task file exported by "
                             "tools/export_tasks_npz.py")
    parser.add_argument("--eval", action="store_true", default=False)
    parser.add_argument("--dump_visualizations", action="store_true",
                        default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")

    # Optimization
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--weight_decay", type=float, default=1e-6)
    # Algorithm
    parser.add_argument("--batches_per_update", type=int, default=1)
    parser.add_argument("--update_frequency", type=int, default=1)
    parser.add_argument("--warmup", type=int, default=128)
    parser.add_argument("--save_ckpt", type=int, default=512)
    parser.add_argument("--dataset_path", type=str, default=None,
                        help="replay directory (default: {log}/"
                             "replay_buffer)")
    parser.add_argument("--action_expl_prob", type=float, default=0.0)
    parser.add_argument("--action_expl_decay", type=float, default=0.9995)
    parser.add_argument("--value_expl_prob", type=float, default=0.0)
    parser.add_argument("--value_expl_decay", type=float, default=0.995)
    parser.add_argument("--obs_color_jitter", action=BooleanOptionalAction,
                        default=True)
    parser.add_argument("--mirror_augment", action=BooleanOptionalAction,
                        default=False,
                        help="x-flip obs+action replay augmentation")
    parser.add_argument("--dihedral_augment", action=BooleanOptionalAction,
                        default=False,
                        help="full D4 obs+action replay augmentation "
                             "(4 rotations x flip = 8 views; supersedes "
                             "--mirror_augment)")
    parser.add_argument("--tta", action=BooleanOptionalAction, default=False,
                        help="dihedral test-time averaging of value maps "
                             "(nets.value_map_inference_tta)")
    parser.add_argument("--domain_randomization",
                        action=BooleanOptionalAction, default=True,
                        help="per-episode randomized floor texture + cloth "
                             "color in the renderer")
    parser.add_argument("--fixed_fling_height", type=float, default=-1)
    parser.add_argument("--fling_speed", type=float, default=6e-3,
                        help="picker speed during the fast fling strokes, "
                             "m/sim-step")
    # Network
    parser.add_argument("--depth_only", action="store_true", default=False)
    parser.add_argument("--rgb_only", action=BooleanOptionalAction,
                        default=True)
    parser.add_argument("--use_adaptive_scaling",
                        action=BooleanOptionalAction, default=True)
    parser.add_argument("--use_normalized_coverage",
                        action=BooleanOptionalAction, default=True)
    parser.add_argument("--conservative_grasp_radius", type=int, default=1)
    parser.add_argument("--action_primitives", nargs="+",
                        choices=["fling", "stretchdrag", "drag", "place"],
                        default=["fling"])
    parser.add_argument("--obs_dim", type=int, default=64)
    parser.add_argument("--pix_grasp_dist", type=int, default=8)
    parser.add_argument("--pix_drag_dist", type=int, default=10)
    parser.add_argument("--pix_place_dist", type=int, default=10)
    parser.add_argument("--stretchdrag_dist", type=float, default=0.3)
    parser.add_argument("--reach_distance_limit", type=float, default=1.2)
    parser.add_argument("--num_rotations", type=int, default=12)
    parser.add_argument("--scale_factors", nargs="+", type=float,
                        default=[1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75])
    parser.add_argument("--render_dim", type=int, default=400)
    parser.add_argument("--episode_length", type=int, default=10)
    # physics knobs: the production operating point
    parser.add_argument("--spring_mode",
                        choices=["gs", "jacobi", "chebyshev"],
                        default="chebyshev")
    parser.add_argument("--backend", choices=["xla", "pallas"],
                        default="pallas",
                        help="pallas: the port's CUDA kernels; xla: the "
                             "plain PyTorch counterpart of the JAX "
                             "package's kernel-free backend")
    parser.add_argument("--substeps", type=int, default=4)
    parser.add_argument("--iterations", type=int, default=16)
    parser.add_argument("--contact_mode",
                        choices=["sort", "sweep", "block", "table"],
                        default="sort",
                        help="self-collision strategy on the xla backend "
                             "and on generic meshes (the pallas grid step "
                             "and layered shirts always sort)")
    parser.add_argument("--contact_every", type=int, default=2)
    parser.add_argument("--contact_iterations", type=int, default=4)
    parser.add_argument("--contact_window", type=int, default=12)
    parser.add_argument("--flex_parity", action="store_true", default=False,
                        help="preset: the reference FleX solver operating "
                             "point (gs springs, 4 substeps x 30 iterations, "
                             "contacts 8/16/every substep, raw scene "
                             "friction 0.75); overrides the production "
                             "solver knobs")
    parser.add_argument("--solver_overrides", type=str, default=None,
                        help="JSON dict of SolverParams overrides, e.g. "
                             "'{\"damping\": 0.0, \"lift\": 0.05}'")
    parser.add_argument("--no_self_collision", action="store_true",
                        default=False)
    parser.add_argument("--max_grid_dim", type=int, default=104)
    parser.add_argument("--env_chunk", type=int, default=None, help=_IGNORED)
    parser.add_argument("--obs_chunk", type=int, default=None, help=_IGNORED)
    parser.add_argument("--exec_mode", choices=["chunked", "fused"],
                        default="chunked", help=_IGNORED)
    parser.add_argument("--chunk_loop", choices=["while", "scan"],
                        default="while", help=_IGNORED)
    parser.add_argument("--chunk_steps", type=int, default=192,
                        help="max interpreter steps per host-driven chunk "
                             "of the fling program")
    parser.add_argument("--dp_devices", type=int, default=None,
                        help=_IGNORED)
    return parser


# flag -> (its default, the ROADMAP item that ports the other values)
_UNPORTED = {
    "dump_visualizations": (False, "Queue 1 item 7"),
}


def apply_presets(args):
    """Post-parse preset expansion (call right after parse_args); raises
    NotImplementedError for a flag value the port cannot reproduce."""
    for flag, (default, item) in _UNPORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: flingbot_tpu_torch runs "
                f"only {default!r} (ROADMAP {item})")
    if args.flex_parity:
        args.spring_mode = "gs"
        args.iterations = 30
        args.contact_every = 1
        args.contact_iterations = 8
        args.contact_window = 16
        # the raw FleX scene friction; the production default is the
        # behaviourally calibrated mu (engine/state.py)
        ov = json.loads(args.solver_overrides or "{}")
        ov.setdefault("dynamic_friction", FLEX_SCENE_FRICTION)
        args.solver_overrides = json.dumps(ov)
    if args.num_processes:
        args.num_envs = args.num_processes
    return args


def solver_params(overrides: str | None) -> SolverParams:
    """SolverParams with a --solver_overrides JSON dict applied, each
    number rounded to float32 as the JAX package keeps it."""
    params = SolverParams()
    if overrides:
        over = json.loads(overrides)
        params = params.replace(**{
            k: tuple(v) if isinstance(v, list) else float(np.float32(v))
            for k, v in over.items()})
    return params


def seed_all(seed: int):
    print(f"SEEDING WITH {seed}")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
