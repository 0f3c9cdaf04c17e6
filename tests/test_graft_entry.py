"""Driver-interface tests: entry() compiles, dryrun_multichip runs on the
virtual 8-device mesh."""

import os
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    sys.path.insert(0, REPO)
    import __graft_entry__

    return __graft_entry__


def test_entry_compiles_and_runs():
    mod = _load()
    fn, args = mod.entry()
    d, i = jax.jit(fn)(*args)
    assert d.shape == (64, 10)
    assert (np.asarray(i) >= 0).all()


def test_dryrun_multichip_eight_devices():
    mod = _load()
    mod.dryrun_multichip(8, cpu=True)


def test_bench_importable():
    sys.path.insert(0, REPO)
    import bench

    assert callable(bench.main)
