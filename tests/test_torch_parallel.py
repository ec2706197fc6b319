"""The port's mesh and sharding rules against the JAX package's, in one
process (no ranks spawned): `mesh_shape` / `make_mesh`'s factorisations and
errors, `llada_param_specs` leaf by leaf, the divisibility fallback,
`best_batch_axes`, and `shard_params`' shard at every mesh coordinate against
the shard JAX's `shard_params` puts on the device there, quantized leaves
included. The collectives' side (gathers, the sharded forward and step) is
`test_torch_distributed.py`'s.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mmada_tpu.core.mesh import make_mesh as jax_make_mesh
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.ops import quantization as jax_quant
from mmada_tpu.parallel import sharding as jax_sharding
from mmada_tpu.parallel.tp_attention import best_batch_axes as jax_best_batch_axes
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core import mesh as M
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.ops import quantization as Q
from mmada_tpu_torch.parallel import sharding
from mmada_tpu_torch.parallel.tp_attention import best_batch_axes

SHAPES = [(1, 4, 1), (1, 2, 2), (1, 1, 4), (2, 2, 1), (2, 1, 2), (1, 8, 1), (2, 2, 2)]


class FakeMesh:
    """The two questions the port's rules ask of a mesh (its axis sizes and
    this rank's coordinates), for one coordinate of a mesh of `shape`."""

    def __init__(self, shape, coord=(0, 0, 0)):
        self.shape, self.coord = tuple(shape), tuple(coord)

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self.coord[M.MESH_AXES.index(name)]


def _jax_mesh(shape):
    return jax_make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])


@pytest.mark.parametrize("n,axes", [
    (8, (1, -1, 1)), (8, (2, -1, 1)), (8, (1, -1, 2)), (8, (-1, 2, 2)), (4, (1, 2, -1)),
    (4, (2, 2, 1)), (2, (1, 1, -1)), (8, (3, -1, 1)), (8, (-1, -1, 1)), (4, (2, 1, 1)),
])
def test_mesh_shape_matches_jax(n, axes):
    """The factorisation of n ranks, or the error JAX raises, word for word."""
    try:
        want = tuple(_jax_mesh_n(n, axes).devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            M.mesh_shape(n, *axes)
        assert str(got.value) == str(e)
        return
    assert M.mesh_shape(n, *axes) == want


def _jax_mesh_n(n, axes):
    return jax_make_mesh(*axes, devices=jax.devices()[:n])


def test_make_mesh_of_one_process():
    """Without a launcher the port's mesh is one rank: (1, 1, 1), its groups
    None, this rank the main process; a mesh asking for more raises."""
    import torch.distributed as dist

    created = not dist.is_initialized()
    try:
        mesh = M.make_mesh(fsdp=-1, device="cpu")
        assert tuple(mesh.shape) == (1, 1, 1) and mesh.mesh_dim_names == M.MESH_AXES
        assert M.world_size(mesh) == 1 and M.axis_group(mesh, M.BATCH_AXES) is None
        assert M.axis_index(mesh, ("fsdp", "tensor")) == 0 and M.is_main_process()
        assert M.process_local_batch_slice(6, mesh) == slice(0, 6)
        assert M.initialize_distributed(device="cpu") is False
        assert tuple(M.single_device_mesh(device="cpu").shape) == (1, 1, 1)
        assert M.batch_sharding(mesh) == tuple(jax_sharding.batch_spec())
        with pytest.raises(ValueError, match="devices"):
            M.make_mesh(data=2, fsdp=1, device="cpu")
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


CONFIGS = {
    "llama": {},
    "llama_gqa_bias": dict(n_kv_heads=2, include_qkv_bias=True),
    "qk_norm_tied": dict(attention_layer_norm=True, weight_tying=True),
    "sequential": dict(block_type="sequential", activation_type="swiglu", include_bias=True),
}


def _cfgs(name):
    over = dict(CONFIGS[name])
    extra = {k: over.pop(k) for k in ("include_qkv_bias", "include_bias") if k in over}
    jcfg = dataclasses.replace(jax_llada.tiny_config(vocab_size=320, **over), **extra)
    return jcfg, llada.LLaDAConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_specs_match_jax_leaf_by_leaf(name):
    jcfg, cfg = _cfgs(name)
    want = jax.tree.map(tuple, jax_sharding.llada_param_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = sharding.llada_param_specs(cfg)
    assert got.keys() == want.keys() and got["blocks"].keys() == want["blocks"].keys()
    for k in got:
        if k == "blocks":
            for kind in got[k]:
                assert got[k][kind] == want[k][kind], kind
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("shape", SHAPES)
def test_divisibility_fallback_matches_jax(shape):
    """Every spec of the tree on dims that divide, dims that do not, and
    joined axes."""
    jmesh = _jax_mesh(shape)
    mesh = FakeMesh(shape)
    specs = sharding.llada_param_specs(llada.tiny_config())
    dims = [(2, 64, 128), (2, 6, 10), (3, 12, 8), (320, 64), (6, 64), (64,), (2, 36)]
    for spec in list(specs["blocks"].values()) + [specs["wte"], specs["ln_f"], specs["ff_out"]]:
        for d in dims:
            if len(d) < len(spec):
                continue
            want = tuple(jax_sharding._divisibility_fallback(
                d, jax.sharding.PartitionSpec(*spec), jmesh))
            assert sharding._divisibility_fallback(d, spec, mesh) == want, (spec, d)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 6, 8])
def test_best_batch_axes_matches_jax(shape, batch):
    assert best_batch_axes(batch, FakeMesh(shape)) == jax_best_batch_axes(batch, _jax_mesh(shape))


def _coords(shape):
    return [tuple(c) for c in np.ndindex(*shape)]


def _jax_shards(arr, jmesh):
    """{mesh coordinate: the shard of `arr` on the device there}."""
    devices = np.asarray(jmesh.devices)
    out = {}
    for shard in arr.addressable_shards:
        coord = tuple(int(i) for i in np.argwhere(devices == shard.device)[0])
        out[coord] = np.asarray(shard.data)
    return out


def _port_leaves(tree):
    """(path, tensor) of a port params tree, quantized leaves' fields apart."""
    out = []
    for name, leaf in tree.items():
        items = leaf.items() if name == "blocks" else [(None, leaf)]
        for kind, t in items:
            path = name if kind is None else f"{name}/{kind}"
            if Q.is_quantized(t):
                for f in dataclasses.fields(t):
                    out.append((f"{path}.{f.name}", getattr(t, f.name)))
            else:
                out.append((path, t))
    return out


def _jax_leaves(tree):
    out = []
    for name, leaf in tree.items():
        items = leaf.items() if name == "blocks" else [(None, leaf)]
        for kind, t in items:
            path = name if kind is None else f"{name}/{kind}"
            if jax_quant.is_quantized(t):
                for f in dataclasses.fields(t):
                    out.append((f"{path}.{f.name}", getattr(t, f.name)))
            else:
                out.append((path, t))
    return out


@pytest.mark.parametrize("shape,scheme", [
    ((1, 4, 1), "none"), ((1, 2, 2), "none"), ((2, 2, 1), "none"), ((1, 1, 4), "none"),
    ((1, 2, 2), "int8"), ((2, 2, 1), "int8"), ((1, 2, 2), "int4"), ((1, 1, 4), "int4")])
def test_shard_params_matches_jax_shards(shape, scheme):
    """At every coordinate of the mesh the port's shard of each leaf (a
    quantized leaf's values and scales) is the shard JAX places on the
    device there, bit for bit; the shards tile the whole leaf. Weights
    whose rows an axis does not divide (the 6-row int8 case) stay whole, as
    JAX's fallback leaves them."""
    d = 128 if scheme == "int4" else 64   # int4: one 128-row group
    jcfg = jax_llada.tiny_config(vocab_size=320, d_model=d, n_heads=4, n_kv_heads=2,
                                 mlp_hidden_size=2 * d)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    jparams = jax_llada.init_params(jax.random.key(0), jcfg)
    if scheme != "none":
        jparams = jax_quant.quantize_llada_params(jparams, bits=4 if scheme == "int4" else 8)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    jmesh = _jax_mesh(shape)
    jsharded = jax_sharding.shard_params(jparams, jax_sharding.llada_param_specs(jcfg), jmesh)
    want = {path: _jax_shards(arr, jmesh) for path, arr in _jax_leaves(jsharded)}
    specs = sharding.llada_param_specs(cfg)
    for coord in _coords(shape):
        local = sharding.shard_params(params, specs, FakeMesh(shape, coord))
        got = dict(_port_leaves(local))
        assert got.keys() == want.keys()
        for path, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[path][coord], err_msg=f"{path} {coord}")


def test_model_specs_keep_tensor_parallelism_only_where_it_holds():
    """The port's own rule: a block runs tensor-parallel only where heads,
    kv heads and MLP hidden divide the axis, on a llama block without q/k
    norms, and with no int4 row shard that cuts a group; otherwise its
    weights replicate over tensor (fsdp is kept). W8A8 weights run
    tensor-parallel: a row-parallel product takes its scales over the whole
    row."""
    mesh = FakeMesh((1, 2, 2))
    cfg = llada.tiny_config(d_model=256, n_heads=4, mlp_hidden_size=512)

    def tensor_in_blocks(c, params=None):
        specs = sharding.model_specs(c, mesh, params)
        return any("tensor" in sharding.spec_axes(s) for s in specs["blocks"].values())

    assert tensor_in_blocks(cfg)
    assert not tensor_in_blocks(dataclasses.replace(cfg, n_heads=2, n_kv_heads=1))
    assert not tensor_in_blocks(dataclasses.replace(cfg, attention_layer_norm=True))
    assert not tensor_in_blocks(dataclasses.replace(cfg, block_type="sequential"))
    params = llada.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert tensor_in_blocks(cfg, Q.quantize_llada_params(params, bits=4))
    assert tensor_in_blocks(cfg, Q.quantize_llada_params(params))
    assert tensor_in_blocks(cfg, Q.quantize_llada_params(params, activations=True))
    small = llada.tiny_config(d_model=64, n_heads=4, mlp_hidden_size=128)
    small_params = llada.init_params(small, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    # K = 64 packs per channel: one group, no row shard of it
    assert not tensor_in_blocks(small, Q.quantize_llada_params(small_params, bits=4))
    specs = sharding.model_specs(dataclasses.replace(cfg, block_type="sequential"), mesh)
    assert specs["blocks"]["attn_out"] == (None, None, "fsdp")
    assert specs["wte"] == (("fsdp", "tensor"), None)


def test_state_layout_names_checkpoint_keys():
    """Checkpoint keys of the params, the moments and the EMA map to their
    weight's spec; counters are whole."""
    cfg = llada.tiny_config()
    names = [n for n, _ in llada.named_leaves(llada.init_params(cfg, device="meta"))]
    layout = sharding.StateLayout(cfg, FakeMesh((1, 2, 2)), names)
    assert layout.spec("train/params/layers/1/q_proj") == ("fsdp", "tensor")
    assert layout.spec("train/opt_state/mu/layers.1.attn_out") == ("tensor", "fsdp")
    assert layout.spec("ema/shadow/wte") == (("fsdp", "tensor"), None)
    assert layout.spec("train/params/ff_out") == ("fsdp", "tensor")
    assert layout.spec("train/params/layers/0/ff_out") == ("tensor", "fsdp")
    assert layout.spec("train/opt_state/count") == () == layout.spec("train/step")
    t = torch.zeros(32, 64)
    assert layout.full_shape("train/params/layers/0/q_proj", t) == (64, 128)
