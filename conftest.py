"""Keep long-lived test processes under the kernel's memory-map ceiling.

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
"""

import gc
import sys

MAP_LIMIT = 20000


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
