"""The placement rules of sharded serving and training against the
reference's, bit for bit.

``models.lm.param_specs`` / ``cache_specs``, ``training.serve._cache_specs``
and ``training.train.state_specs`` of the port are host logic over shapes and
integer axis sizes; so are the reference's (``repro/models/lm.py``,
``repro/training/serve.py``, ``repro/training/train.py``), which need no
mesh of devices.  Every config of ``configs/``, full and ``reduced()``, on
the meshes ``(data, model)`` in ``{(1, 1), (4, 1), (2, 2), (1, 4)}``: the
reference's ``PartitionSpec`` trees, turned into tuples, equal the port's
``spmd.Spec`` trees.  The shapes come from ``jax.eval_shape`` and the
port's ``"meta"`` device, so full-width configs allocate nothing.
"""
import dataclasses

import pytest

from test_torch_helpers import reference

MESHES = ((1, 1), (4, 1), (2, 2), (1, 4))
# (B, max_len): a short cache (the reference's `_cache_specs` reads it as a
# recurrent state and shards its sequence over "model"), one at 1024, a
# long one (> 4096: `cache_specs`'s KV branch) at B = 1
CACHES = ((4, 64), (8, 1024), (1, 4608))
_SHAPES = {}


def _plain(tree, spec_type):
    """A spec tree as nested dicts / lists / tuples with each spec as
    ``("spec", entries)``; namedtuples as their field values."""
    if isinstance(tree, spec_type):
        return ("spec", tuple(tree))
    if isinstance(tree, dict):
        return {k: _plain(v, spec_type) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v, spec_type) for v in tree) \
            if not hasattr(type(tree), "_fields") \
            else tuple(_plain(v, spec_type) for v in tree)
    return tree


def _reference_shapes(arch, reduced):
    key = (arch, reduced)
    if key not in _SHAPES:
        ref = reference()
        cfg = ref.configs.get_config(arch)
        cfg = cfg.reduced() if reduced else cfg
        model = ref.lm.LM(cfg)
        params = ref.jax.eval_shape(model.init, ref.jax.random.PRNGKey(0))
        caches = {c: ref.jax.eval_shape(lambda c=c: model.init_cache(*c))
                  for c in CACHES}
        _SHAPES[key] = (model, params, caches)
    return _SHAPES[key]


def _port_model(arch, reduced):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = get_config(arch)
    return LM(cfg.reduced() if reduced else cfg)


def _ref_plain(tree):
    return _plain(tree, reference().jax.sharding.PartitionSpec)


def _port_plain(tree):
    from repro_torch.core import spmd
    return _plain(tree, spmd.Spec)


ARCHS = ["zamba2_2p7b", "stablelm_1p6b", "mistral_nemo_12b", "qwen3_32b",
         "gemma3_27b", "mixtral_8x22b", "deepseek_moe_16b", "rwkv6_3b",
         "paligemma_3b", "musicgen_large"]


def test_every_config_is_covered():
    from repro_torch.configs import ARCH_IDS
    assert sorted(ARCH_IDS) == sorted(ARCHS)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_the_reference(arch, reduced):
    ref = reference()
    rmodel, rparams, rcaches = _reference_shapes(arch, reduced)
    from repro_torch.models import lm
    from repro_torch.training import serve
    pmodel = _port_model(arch, reduced)
    pshapes = pmodel.param_shapes()
    for data, model in MESHES:
        for fsdp in (True, False):
            want = _ref_plain(ref.lm.param_specs(rparams, data, model, fsdp))
            got = _port_plain(lm.param_specs(pshapes, data, model, fsdp))
            assert got == want, (data, model, fsdp)
        for c in CACHES:
            B, max_len = c
            pc = pmodel.init_cache(B, max_len, "meta")
            for shard_seq in (False, True):
                want = _ref_plain(ref.lm.cache_specs(
                    rcaches[c], ("data",), B, data, model, shard_seq))
                got = _port_plain(lm.cache_specs(pc, ("data",), B, data,
                                                 model, shard_seq))
                assert got == want, (data, model, c, shard_seq)
            dp = data
            want = _ref_plain(ref.serve._cache_specs(
                rcaches[c], ("data",), dp, B, data, model))
            got = _port_plain(serve._cache_specs(pc, ("data",), dp, B, data,
                                                 model))
            assert got == want, (data, model, c)
            # serve_shardings returns the reference's two trees
            sh = serve.serve_shardings(
                pmodel, {"data": data, "model": model},
                serve.ServeCfg(max_len=max_len, batch=B))
            assert _port_plain(sh.cache) == want
            assert _port_plain(sh.params) == _ref_plain(
                ref.lm.param_specs(rparams, data, model, fsdp=False))


@pytest.mark.parametrize("arch", ["stablelm_1p6b", "rwkv6_3b",
                                  "deepseek_moe_16b", "zamba2_2p7b"])
def test_state_specs_equal_the_reference(arch):
    """AdamW (moments as the parameters) and SGD (a moment-less ``nu``,
    ``P()``), with and without ZeRO-3, reduced and full."""
    reference()
    from repro.training import optimizer as ropt, train as rtrain
    from repro_torch.training import optimizer as popt, train as ptrain
    for reduced in (True, False):
        rmodel = _reference_shapes(arch, reduced)[0]
        pmodel = _port_model(arch, reduced)
        for ro, po in ((ropt.adamw(), popt.adamw()), (ropt.sgd(), popt.sgd())):
            for data, model in MESHES:
                for fsdp in (True, False):
                    want = _ref_plain(rtrain.state_specs(rmodel, ro, data,
                                                         model, fsdp))
                    got = _port_plain(ptrain.state_specs(pmodel, po, data,
                                                         model, fsdp))
                    assert got == want, (reduced, data, model, fsdp)


def test_held_layouts_differ_only_where_the_forward_needs_it():
    """The port holds the reference's placements except: ``wk`` / ``wv``
    whole over ``"model"`` where the kv heads do not split (reduced
    StableLM's 2 kv heads on 4 ranks); a KV cache never split along its
    sequence, its kv heads over ``"model"`` where they split; the token
    shifts whole along ``d``; a Mamba2 convolution state over its
    channels."""
    from repro_torch.core import spmd
    from repro_torch.models import lm
    from repro_torch.training import serve
    pm = _port_model("stablelm_1p6b", True)
    sh = serve.serve_shardings(pm, {"data": 1, "model": 4},
                               serve.ServeCfg(max_len=64, batch=4))
    attn = sh.params["stack"]["0"]["attn"]
    held = sh.held_params["stack"]["0"]["attn"]
    assert attn["wk"] == (None, None, "model")
    assert held["wk"] == (None, None, None) == held["wv"]
    assert held["wq"] == attn["wq"] and held["wo"] == attn["wo"]
    # the reference's short-cache rule puts the sequence on "model"
    assert sh.cache["stack"]["0"]["kv"][0] == (None, "data", "model",
                                               None, None)
    assert sh.held_cache["stack"]["0"]["kv"][0] == (None, "data", None,
                                                    None, None)
    rw = _port_model("rwkv6_3b", True)
    sh = serve.serve_shardings(rw, {"data": 2, "model": 2},
                               serve.ServeCfg(max_len=64, batch=4))
    c, h = sh.cache["stack"]["0"], sh.held_cache["stack"]["0"]
    assert c["state"] == h["state"] == (None, "data", "model", None, None)
    assert c["ptm"] == (None, "data", "model")
    assert h["ptm"] == h["pcm"] == (None, "data", None)
    # the held cache is what init_cache allocates on a mesh: local shapes
    sizes = {"data": 2, "model": 2}
    shapes = rw.init_cache(4, 64, "meta")
    assert spmd.local_shape(shapes["stack"]["0"]["state"].shape,
                            h["state"], sizes) == (2, 2, 2, 16, 16)
    assert lm.held_param_specs(sh.params, rw.cfg, 2) is sh.params
    # a Mamba2 scan state over its heads and its convolution state over
    # its channels, as the reference's serving rule places them (its
    # models.lm.cache_specs would put "model" on dc - 1 = 3, which does
    # not split)
    zb = _port_model("zamba2_2p7b", True)
    sh = serve.serve_shardings(zb, {"data": 2, "model": 2},
                               serve.ServeCfg(max_len=64, batch=4))
    c, h = sh.cache["stack"]["0"], sh.held_cache["stack"]["0"]
    assert c["ssm"] == h["ssm"] == (None, "data", "model", None, None)
    assert c["conv"] == h["conv"] == (None, "data", None, "model")
    conv = zb.init_cache(4, 64, "meta")["stack"]["0"]["conv"][0]
    assert lm.cache_specs({"conv": conv}, ("data",), 4, 2, 2)["conv"] == \
        ("data", None, None)
    shapes = zb.init_cache(4, 64, "meta")["stack"]["0"]
    assert spmd.local_shape(shapes["conv"].shape, h["conv"], sizes) == \
        (2, 2, 3, 64)
    assert spmd.local_shape(shapes["ssm"].shape, h["ssm"], sizes) == \
        (2, 2, 4, 8, 16)
    assert lm.held_param_specs(sh.params, zb.cfg, 2) is sh.params


def test_moe_and_mamba2_under_model_split_name_the_queue():
    """MoE and Mamba2 blocks split over ``"model"``: every MoE and hybrid
    config, full and reduced, passes the check at 2 and 4 ranks (expert
    and shared-expert columns, Mamba2 and attention heads all divide);
    one whose expert columns, shared-expert columns or Mamba2 heads do
    not divide is refused, naming what does not split."""
    from repro_torch.models import lm
    for arch in ("deepseek_moe_16b", "mixtral_8x22b", "zamba2_2p7b"):
        for reduced in (True, False):
            cfg = _port_model(arch, reduced).cfg
            for model in (2, 4):
                lm._check_tensor_parallel(cfg, model)
    for arch in ("stablelm_1p6b", "rwkv6_3b", "qwen3_32b", "gemma3_27b"):
        lm._check_tensor_parallel(_port_model(arch, False).cfg, 4)
    ds = _port_model("deepseek_moe_16b", True).cfg
    zb = _port_model("zamba2_2p7b", True).cfg
    for cfg, what in (
            (dataclasses.replace(ds, d_ff_expert=30), "30 expert columns"),
            (dataclasses.replace(ds, d_ff_shared=18), "18 shared-expert"),
            (dataclasses.replace(zb, mamba_head_dim=64), "2 Mamba2 heads"),
            (dataclasses.replace(_port_model("stablelm_1p6b", True).cfg,
                                 n_heads=6, n_kv_heads=2), "6 attention")):
        with pytest.raises(NotImplementedError, match=what) as e:
            lm._check_tensor_parallel(cfg, 4)
        assert "do not split" in str(e.value)
    # Zamba2's full width: 80 Mamba2 heads split over 4 (and 16, not 32)
    full = _port_model("zamba2_2p7b", False).cfg
    lm._check_tensor_parallel(full, 16)
    with pytest.raises(NotImplementedError, match="80 Mamba2 heads"):
        lm._check_tensor_parallel(full, 32)


def test_spec_is_a_plain_tuple_and_pickles():
    import pickle
    from repro_torch.core import spmd
    s = spmd.Spec(("data",), None, "model")
    assert s == ("data", None, "model") and spmd.Spec() == ()
    assert spmd.Spec(("pod", "data"), None) == (("pod", "data"), None)
    assert pickle.loads(pickle.dumps(s)) == s
    assert type(pickle.loads(pickle.dumps(s))) is spmd.Spec
    assert s.axes() == {"data", "model"} and s.dim_of("model") == 2
    assert spmd.local_shape((8, 3, 12), s, {"data": 2, "model": 4}) == \
        (4, 3, 3)
