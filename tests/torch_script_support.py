"""Helpers of the port's script tests (tests/test_torch_protocols.py,
test_torch_bench.py, test_torch_step_tools.py): the repository's JAX
scripts (``bench.py``, ``benchmarks/*.py``) imported by path, and the
config of a JAX script's ``pipeline.build`` call captured in-process by
replacing the JAX ``pipeline.build`` with one that records its config
and stops the script.
"""

import contextlib
import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import jax
import pytest

import mpc_sensorlessao_tpu.models.pipeline as jpipeline

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _restored_jax_state():
    """The JAX scripts set a persistent compilation cache under /tmp and
    put their directory on sys.path when imported: undo both."""
    path = list(sys.path)
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        yield
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          cache[1])


def _jax_script(name: str) -> types.ModuleType:
    """The repository's benchmarks/<name>.py (``bench``: the root
    bench.py), imported by path."""
    path = (ROOT / "bench.py" if name == "bench"
            else ROOT / "benchmarks" / f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    with _restored_jax_state():
        spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _captured_cfg(monkeypatch, name, argv, env, prepare=None):
    """The config of the JAX script's first pipeline.build call under
    ``argv`` and ``env``; ``prepare(module)`` may replace what the script
    runs before that call."""
    mod = _jax_script(name)

    def build(cfg, key):
        raise _Captured(cfg)
    monkeypatch.setattr(jpipeline, "build", build)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if prepare is not None:
        prepare(mod)
    with pytest.raises(_Captured) as got:
        mod.main()
    return got.value.args[0]


def _same(jax_cfg, port_cfg):
    assert dataclasses.asdict(jax_cfg) == dataclasses.asdict(port_cfg)
