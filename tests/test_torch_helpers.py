"""Shared helper of the port's tests, and the port's import hygiene.

:func:`reference` imports the JAX package (``repro``) as the oracle the
PyTorch port (``repro_torch``) is held against.  It must only ever be called
from inside a test or a fixture, never while a test module is imported:
every test process collects the whole suite before it runs anything, and an
import of ``repro`` at collection time would change which of the reference's
own test files can be imported in that process.

With the installed jax, ``repro.models.lm`` fails to import
(``p not in batching.primitive_batchers`` raises ``TypeError`` for
``optimization_barrier_p``), and ``repro.core`` imports it.  The helper hides
``optimization_barrier_p`` for the duration of that one import — the module
then takes its "rules built in" branch — and restores it.  Nothing in
``src/repro`` changes.
"""
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

_REFERENCE = None


def reference():
    """The JAX package's modules as one namespace (cached per process)."""
    global _REFERENCE
    if _REFERENCE is not None:
        return _REFERENCE
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from jax._src.lax import lax as lax_internal
    saved = getattr(lax_internal, "optimization_barrier_p", None)
    lax_internal.optimization_barrier_p = None
    try:
        import repro.models.lm  # noqa: F401  (the import is the point)
    finally:
        lax_internal.optimization_barrier_p = saved
    from repro.analysis import roofline
    from repro.core import (analysis, bcd, engine, linearize, masks, pi_cost,
                            runner)
    from repro.kernels import masked_act, ops, ref, rwkv6_scan
    from repro.launch import faults, serve_loop, sweep
    from repro.models import layers, lm, moe, resnet, ssm
    from repro.training import checkpoint, serve
    import repro.configs as configs
    import repro.data as data
    _REFERENCE = types.SimpleNamespace(
        jax=jax, jnp=jnp, bcd=bcd, engine=engine, linearize=linearize,
        masks=masks, masked_act=masked_act, ops=ops, ref=ref, resnet=resnet,
        data=data, roofline=roofline, lm=lm, layers=layers, configs=configs,
        ssm=ssm, moe=moe, rwkv6_scan=rwkv6_scan, analysis=analysis,
        pi_cost=pi_cost,
        runner=runner, sweep=sweep, checkpoint=checkpoint, faults=faults,
        serve_loop=serve_loop, serve=serve)
    return _REFERENCE


def to_numpy_tree(tree):
    """A pytree of jax arrays -> the same nested dicts, lists, tuples and
    namedtuples of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(to_numpy_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    return np.asarray(tree)


def tree_leaves(tree):
    """Every leaf of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def to_jax_tree(ref, tree):
    """A tree of the port's tensors -> the same nested dicts, lists and
    tuples of jax arrays of the same dtypes and bits (bfloat16 stays
    bfloat16)."""
    if isinstance(tree, dict):
        return {k: to_jax_tree(ref, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax_tree(ref, v) for v in tree)
    import torch
    a = ref.jnp.asarray(tree.float().numpy())
    return a.astype(ref.jnp.bfloat16) if tree.dtype == torch.bfloat16 else a


def cast_floats(tree, dtype):
    """Nested dicts, lists and tuples of tensors with every floating
    tensor cast to ``dtype`` (integer tensors and other leaves as they
    are)."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if hasattr(tree, "is_floating_point") and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def float64_torch():
    """``(modules, stand_in)``: the port's modules whose upcasts name
    ``torch.float32`` (the models' blocks, the kernels' plain versions),
    and a stand-in for their ``torch`` that reads ``float32`` as
    ``float64``.  Set as each module's ``torch``, the port's plain path,
    given float64 parameters and caches (:func:`cast_floats`), evaluates
    the same function in float64."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import layers, lm, ssm

    class Float64Torch:
        float32 = torch.float64

        def __getattr__(self, name):
            return getattr(torch, name)
    return (ref, layers, lm, ssm), Float64Torch()


def random_masks(sites, seed, density=0.6):
    """Random binary mask tree for a ``mask_sites()`` dict, from numpy."""
    rng = np.random.default_rng(seed)
    return {k: (rng.random(s.shape) < density).astype(np.float32)
            for k, s in sites.items()}


def _rank_main(fn, rank, world, store_path, args, queue):
    """One spawned rank: a ``FileStore`` process group on the CPU, then
    ``fn(rank, world, *args)``; its result or its error goes on
    ``queue``."""
    import traceback
    import torch
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist
        from repro_torch.launch import mesh
        mesh.init_process_group("cpu", store=dist.FileStore(store_path,
                                                            world),
                                rank=rank, world=world, timeout_s=120)
        try:
            queue.put((rank, "ok", fn(rank, world, *args)))
        finally:
            mesh.shutdown()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world, tmp_path, *args, timeout=120):
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    ``gloo`` process group on the CPU (a ``FileStore`` under ``tmp_path``,
    no port); returns the ranks' results in rank order.  ``fn`` lives at a
    test module's top level and returns something picklable.  A rank that
    fails or does not answer within ``timeout`` seconds fails the test,
    and every rank is ended."""
    import queue as queue_lib
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(tmp_path), "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            try:
                rank, status, value = results.get(timeout=timeout)
            except queue_lib.Empty:
                raise AssertionError(f"a rank gave no answer in {timeout} s")
            assert status == "ok", f"rank {rank}:\n{value}"
            out[rank] = value
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


# ------------------------------------------------------------ import hygiene


def test_port_imports_neither_jax_nor_reference_package():
    """Every module of the port, and every ``examples/torch_*.py``, imports
    with ``jax`` and ``repro`` blocked."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None          # any import of it now raises
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        assert len(names) >= 15, names
        assert {"repro_torch.configs", "repro_torch.configs.base",
                "repro_torch.configs.stablelm_1p6b", "repro_torch.models.lm",
                "repro_torch.models.layers", "repro_torch.models.moe",
                "repro_torch.models.ssm",
                "repro_torch.training.checkpoint", "repro_torch.core.runner",
                "repro_torch.launch.coordinator", "repro_torch.launch.sweep",
                "repro_torch.launch.faults", "repro_torch.launch.serve",
                "repro_torch.launch.serve_loop",
                "repro_torch.training.serve",
                "repro_torch.core.analysis",
                "repro_torch.core.pi_cost"} <= set(names), names
        for n in names:
            importlib.import_module(n)
        # and the port's examples, as modules (their main() not run)
        import glob, importlib.util, os
        for path in sorted(glob.glob(os.path.join(EXAMPLES,
                                                  "torch_*.py"))):
            spec = importlib.util.spec_from_file_location(
                os.path.basename(path)[:-3], path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("imported", len(names))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    code = f"EXAMPLES = {os.path.join(root, 'examples')!r}\n" + code
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_package_init_imports_nothing_eagerly():
    code = textwrap.dedent("""
        import sys
        import repro_torch, repro_torch.core, repro_torch.kernels
        import repro_torch.models
        assert "torch" not in sys.modules, "torch imported eagerly"
        assert "repro_torch.core.engine" not in sys.modules
        assert "repro_torch.kernels.masked_act" not in sys.modules
    """)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def test_sharded_backend_says_it_is_not_ported_yet():
    """The sharded backend is ported now (``tests/test_torch_sharded.py``
    runs it): the factory checks its arguments before it touches a process
    group, and still refuses an unknown backend."""
    from repro_torch.core import engine
    with pytest.raises(ValueError, match="needs a device eval_fn"):
        engine.make_evaluator("sharded")
    with pytest.raises(ValueError, match="unknown evaluator backend"):
        engine.make_evaluator("nope")


def test_entry_points_default_to_the_card():
    import inspect
    from repro_torch import convert
    from repro_torch.core import engine, linearize, masks, runner
    from repro_torch.launch import sweep
    from repro_torch.models import resnet
    from repro_torch.training import checkpoint
    fns = [checkpoint.restore, runner.restore_run_state,
           runner.load_stage_init, runner.BCDRunner.__init__,
           sweep.run_sweep, convert.to_device, convert.params_from_reference,
           convert.masks_from_reference, masks.as_device,
           linearize.init_poly, engine.make_evaluator,
           engine.BatchedEvaluator.__init__,
           engine.PipelinedEvaluator.__init__,
           engine.SuffixEvaluator.__init__, sweep.make_bcd_evaluator,
           resnet.CNN.init, resnet.CNN.make_eval_acc,
           resnet.CNN.make_param_eval_fn, resnet.CNN.make_eval_fn]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never serve a CPU tensor (ops does, through the
    plain version), and say so instead of falling back."""
    import torch
    from repro_torch.kernels import build, masked_act as K
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.masked_act_2d(x, torch.ones(8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.masked_act_2d_batched(x[None], torch.ones(1, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.masked_act_conv3x3(torch.zeros(1, 4, 4, 2), torch.ones(4, 4, 2),
                             torch.zeros(3, 3, 2, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.masked_act_conv3x3_batched(torch.zeros(1, 1, 4, 4, 2),
                                     torch.ones(1, 4, 4, 2),
                                     torch.zeros(3, 3, 2, 2))
    assert all(v == 0 for v in build.launch_counts.values())


def test_build_without_compiler_raises(tmp_path, monkeypatch):
    """No nvcc: asking for the library raises, it does not fall back."""
    from repro_torch.kernels import build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", build.find_nvcc)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
    assert len(build.sources()) >= 1


def test_convert_roundtrip_keeps_keys_and_values():
    import torch
    from repro_torch import convert
    tree = {"a": {"w": np.arange(6, dtype=np.float64).reshape(2, 3)},
            "b": np.ones((2,), np.float32)}
    out = convert.params_from_reference(tree, "cpu")
    assert set(out) == {"a", "b"} and out["a"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(out["a"]["w"].numpy(), tree["a"]["w"])
    m = convert.masks_from_reference({"s": np.array([0, 1, 0.75])}, "cpu")
    assert m["s"].dtype == torch.float32
    np.testing.assert_array_equal(m["s"].numpy(),
                                  np.array([0, 1, 0.75], np.float32))
    labels = convert.to_device({"l": np.array([1, 2], np.int32)}, "cpu")
    assert labels["l"].dtype == torch.int32
