"""Multi-process (multi-host / host axis) validation.

Launches tools/multihost_dryrun.py: N real OS processes joined via
jax.distributed over virtual CPU devices, the global (host, carrier,
sf) mesh, the full no-genie ue_dl chain sharded over all three axes
with a cross-host psum, and the trellis-sharded NII turbo decode whose
ppermute boundary exchange crosses the process boundary. This is the
"1 card -> 1 host -> N hosts" structural evidence from BASELINE
(SURVEY.md section 2.7 / section 7 stage 10) validated without
multi-host hardware.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from empower_srslte_tpu.parallel import make_mesh


def test_make_mesh_host_axis():
    import jax

    m = make_mesh(8, hosts=2)
    assert m.axis_names == ("host", "carrier", "sf")
    assert m.shape["host"] == 2 and m.shape["sf"] == 4


def test_multihost_dryrun_two_processes():
    tool = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "multihost_dryrun.py")
    env = dict(os.environ, MH_PORT="29531")
    # the workers force their own XLA_FLAGS / platform; scrub the test
    # session's so the child count isn't doubled
    env.pop("XLA_FLAGS", None)
    # outer timeout > the tool's internal worker deadline (MH_TIMEOUT_S,
    # default 480 s), so on a slow box the tool reaps its own workers
    # and exits cleanly instead of pytest killing the launcher and
    # orphaning the processes that hold the coordinator port
    out = subprocess.run([sys.executable, tool, "2"], env=env,
                        capture_output=True, text=True, timeout=540)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "MULTIHOST_OK" in out.stdout
