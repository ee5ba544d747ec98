"""The port's multi-device dry run (flingbot_tpu_torch.parallel.dryrun,
the counterpart of __graft_entry__.dryrun_multichip) at 2 gloo ranks of
one env each on the CPU: the JAX dry run's folded cloth through a
sharded BatchSimEnv collect round whose fling programs are cut after 8
sim steps (then the settle), the replay record read back in env order,
and one data-parallel optimize step.

Marked slow, as the JAX package's tests/test_parallel_chunked.py is: the
two ranks' collect runs ~330 interpreter steps each (the settle after
the cut program), 44 s when both ranks share one CPU (24 s on an idle
8-core host).  Run it with `-m slow`."""

import numpy as np
import pytest
import torch

from flingbot_tpu_torch.parallel import dryrun

pytestmark = pytest.mark.slow
torch.set_num_threads(2)


def test_dryrun_two_ranks(capsys):
    out = dryrun.dryrun_multichip(2, "cpu", num_envs=2,
                                  env_kw={"max_program_steps": 8})
    assert out["episodes"] == 2 and out["envs"] == 1
    assert out["device"] == "cpu" and np.isfinite(out["loss"])
    assert "[dryrun_multichip] 2 ranks OK" in capsys.readouterr().out
