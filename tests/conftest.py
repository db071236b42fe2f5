"""Pytest config. NOTE: no XLA device-count flag here — smoke tests and
benches must see 1 device (the 512-device override lives ONLY in
launch/dryrun.py and subprocess-based sharding tests).

Hypothesis fallback: three modules use property-based tests. When the
`hypothesis` package is absent (it is not baked into every image — see
requirements-dev.txt) we install a minimal stub BEFORE collection, so the
modules import cleanly and every @given test reports SKIPPED instead of
the whole module erroring out of collection.
"""
import os
import sys
import types

import pytest

# Hermeticity: a user-level autotune cache could route the ops.* wrappers
# to the XLA reference impl, turning every kernel-vs-oracle test vacuous.
# Tests always run the default (Pallas) configs; autotune-specific tests
# set REPRO_AUTOTUNE explicitly per-case via monkeypatch.
os.environ.setdefault("REPRO_AUTOTUNE", "off")

try:  # real hypothesis wins whenever it is installed
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover - depends on environment
    class _AnyStrategy:
        """Stands in for any strategy object/combinator; tests never run."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

        def __repr__(self):
            return "<hypothesis stub strategy>"

    _ANY = _AnyStrategy()

    def _given(*_args, **_kwargs):
        def deco(fn):
            # zero-arg wrapper WITHOUT functools.wraps: copying __wrapped__
            # would make pytest introspect the original signature and hunt
            # for fixtures named after the hypothesis-provided arguments.
            def wrapper():
                pytest.skip("hypothesis not installed "
                            "(pip install -r requirements-dev.txt)")
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def _settings(*_args, **_kwargs):
        if _args and callable(_args[0]) and not _kwargs:
            return _args[0]  # bare @settings
        return lambda fn: fn

    def _assume(condition):
        return bool(condition)

    _hyp = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _ANY  # PEP 562: st.<anything>
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.assume = _assume
    _hyp.strategies = _st
    _hyp.HealthCheck = _ANY
    _hyp.__stub__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (deselect with "
        "-m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels); skipped "
        "without one")
