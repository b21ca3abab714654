"""Keep long-lived test processes under the kernel's memory-map ceiling,
and run the longest tests last.

XLA's CPU compiler loads each compiled executable's code into memory
mappings of its own, and jax keeps every executable cached for the life of
the process. A pytest worker that runs many test files therefore gathers
mappings until a compile crosses ``vm.max_map_count`` (65530 by default on
Linux) and the worker dies with SIGSEGV or SIGABRT inside
``backend_compile_and_load`` (ROADMAP F6). One closed loop of
tests/test_stiction.py alone takes about 33k mappings, so whether it
survives depends on what its worker ran before it.

Before each test, once the process holds more than ``MAP_LIMIT`` mappings,
this hook drops jax's caches; the executables are rebuilt on their next
call. No test depends on what jax has cached.

The suite's twelve longest tests (each 4 to 11 minutes on an 8-core x86
CPU under six xdist workers, about 2200 s for the whole suite) run after
all the others, so that the many short tests are not queued behind them and
a run stopped by a time limit has completed the short tests. xdist's load
scheduler gives each worker about two of them: the six shorter first, then
the six longer, so that each worker's two sum to about the same time. The
xfail canary of an upstream JAX bug comes after them, on the worker that
frees up first, behind its second long test, so that until near the end
every progress mark of the run is a pass or a skip. Nothing else about the
order changes.

A time limit ends the run with SIGTERM. Python's default action for it
kills the controller at once, before pytest writes any report, so a cut
run leaves no JUnit XML and only its progress marks tell what ran. In the
controller (not in an xdist worker) SIGTERM therefore ends the session as
Ctrl-C does: pytest stops, takes down its workers and writes its reports,
the JUnit XML with the tests that completed. A test that did not finish is
not reported; the run still ends at the limit with the limit's exit code.
"""

import gc
import signal
import sys

MAP_LIMIT = 20000

RUN_LAST = (
    # first on each worker: the six shorter of the twelve, shortest first
    "tests/test_estloop.py::test_ground_truth_path_unchanged",
    "tests/test_campaign.py::test_batch_campaign_matches_per_agent",
    "tests/test_estimation.py::test_kf_constant_velocity_tracking",
    "tests/test_estloop.py::test_sensor_model_static_reads",
    "tests/test_wholebody_sharded.py::"
    "test_run_batch_event_sharded_matches_unsharded_fast",
    "tests/test_mpc_batch.py::test_batch_cycle_matches_vmap[lanes]",
    # then the six longer, longest first, so that each worker's pair sums
    # to about the same time
    "tests/test_golden.py::test_golden_template_campaign",
    "tests/test_stiction.py::test_trot_trajectory_unchanged",
    "tests/test_estloop.py::test_team_batch_estimation_smoke",
    "tests/test_wholebody_sharded.py::"
    "test_run_batch_sharded_matches_unsharded_fast",
    "tests/test_wholebody_sharded.py::"
    "test_run_team_batch_sharded_matches_unsharded_fast",
    "tests/test_stiction.py::test_static_lateral_push_creep_eliminated",
    "tests/test_jax_cpu_transpose_bug.py::"
    "test_upstream_transpose_constant_folding",
)


def _interrupt(signum, frame):
    raise KeyboardInterrupt(f"signal {signum}")


def pytest_configure(config):
    if not hasattr(config, "workerinput"):       # the controller only
        signal.signal(signal.SIGTERM, _interrupt)


def _map_count():
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # not Linux: no map ceiling to guard
        return 0


def pytest_runtest_setup(item):
    jax = sys.modules.get("jax")
    if jax is not None and _map_count() > MAP_LIMIT:
        jax.clear_caches()
        gc.collect()


def pytest_collection_modifyitems(config, items):
    rank = {nodeid: i for i, nodeid in enumerate(RUN_LAST)}
    items.sort(key=lambda item: rank.get(item.nodeid, -1))
