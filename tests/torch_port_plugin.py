"""Pytest plugin loaded by `pytest_plugins` in every tests/test_torch_*.py.

Its hook acts on the whole pytest session, not on the port's tests alone:
once any tests/test_torch_*.py file is collected, every test module of the
run, the JAX package's own included, starts with JAX's caches empty. A run
that collects no tests/test_torch_*.py file runs without it.
"""

import gc

import jax
import pytest


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    """Drop every JAX executable of the process after each test module.

    XLA:CPU maps each loaded executable's code into the process: one eager
    zm_convr takes about 21,000 mappings, one test module up to 40,000. An
    xdist worker runs many modules in one process, and when it reaches the
    kernel's vm.max_map_count (65,530 by default) it dies in its next mmap,
    inside a compile or a compilation-cache load. So JAX's caches are
    cleared, and their code unmapped, whenever a process moves on to
    another test module. A module then reloads what it needs from the
    persistent compile cache.
    """
    if nextitem is None or nextitem.path != item.path:
        jax.clear_caches()
        gc.collect()
