"""Scoped access to the JAX package's models, configs and serving engine,
for the port's parity tests.

Under the installed jax, ``repro.kernels.mach_fused_xent`` does not
import (it calls ``pltpu.TPUCompilerParams``), and every import chain of
``repro.models``, ``repro.serving`` and ``repro.configs`` reaches it
through ``repro.kernels.ops``.  ``jax_reference()`` puts a stand-in for
that one module into ``sys.modules`` — ``GATHER_NNZ_THRESHOLD`` and four
functions that raise — imports the three packages, and on exit removes
every ``repro.*`` module and attribute it added, so other test files in
the same process see what they saw before.  Nothing on the CPU serving
path reaches the stand-in: the JAX ops send CPU arrays to
``repro.kernels.ref``.  The JAX package is not edited and ``pltpu`` is
not patched.  Nothing is installed at import or collection time: only
the context manager (and the ``jax_lm`` fixture built on it) does.
"""

import contextlib
import importlib
import sys
import types

import pytest

STAND_IN = "repro.kernels.mach_fused_xent"
PACKAGES = ("repro.configs", "repro.models", "repro.serving")


def _stand_in() -> types.ModuleType:
    mod = types.ModuleType(STAND_IN)
    mod.GATHER_NNZ_THRESHOLD = 512

    def unavailable(*args, **kwargs):
        raise RuntimeError(f"{STAND_IN} is a test stand-in: the fused-xent "
                           f"Pallas kernels are not available here")

    for name in ("choose_sparse_blocks", "mach_fused_xent_pallas",
                 "mach_fused_xent_sparse_pallas",
                 "mach_fused_xent_gather_pallas"):
        setattr(mod, name, unavailable)
    return mod


def _is_repro(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@contextlib.contextmanager
def jax_reference():
    """Yield a namespace of the JAX package's LM modules (configs,
    models, layers, recurrent, attention, transformer, xlstm, frontends,
    model, serving, engine), importable only inside the block."""
    modules_before = set(sys.modules)
    attrs_before = {name: set(vars(mod)) for name, mod in sys.modules.items()
                    if _is_repro(name) and mod is not None}
    sys.modules[STAND_IN] = _stand_in()
    try:
        ns = types.SimpleNamespace()
        for name in PACKAGES + ("repro.models.layers", "repro.models.recurrent",
                                "repro.models.attention",
                                "repro.models.transformer",
                                "repro.models.xlstm",
                                "repro.models.frontends",
                                "repro.models.model", "repro.serving.engine"):
            setattr(ns, name.rsplit(".", 1)[1], importlib.import_module(name))
        yield ns
    finally:
        for name in set(sys.modules) - modules_before:
            if _is_repro(name):
                del sys.modules[name]
        for name, attrs in attrs_before.items():
            mod = sys.modules.get(name)
            if mod is not None:
                for attr in set(vars(mod)) - attrs:
                    delattr(mod, attr)


@pytest.fixture(scope="module")
def jax_lm():
    """The ``jax_reference()`` namespace for one test module."""
    with jax_reference() as ns:
        yield ns
