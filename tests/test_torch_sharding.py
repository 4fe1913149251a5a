"""The port's sharding strategies (``repro_torch.sharding.strategy``) give
the reference's answers (``repro.sharding.strategy``) for every ported
arch, every strategy and the production and test meshes: the rules, the
param pspecs (``spec_to_pspec`` leaf by leaf), the train-state pspecs at
ZeRO 0 and 1 (params, both moments), the batch pspecs and the cache
pspecs.  Both sides take a duck-typed mesh (``.shape`` and
``.axis_names``), so no device is needed.  Pspecs compare exactly: the
reference's ``PartitionSpec`` as a tuple against the port's tuple."""
import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import reward as JR
from repro.models import transformer as JT
from repro.sharding import strategy as JS
from repro_torch import configs as tconfigs
from repro_torch.models import reward as TR
from repro_torch.models import transformer as TT
from repro_torch.sharding import strategy as TS


class FakeMesh:
    """Duck-typed mesh: only .shape and .axis_names are consulted."""

    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x1": {"data": 2, "model": 1}, "4x1": {"data": 4, "model": 1},
          "2x2": {"data": 2, "model": 2}, "1x2": {"data": 1, "model": 2}}
ARCHS = sorted(tconfigs.list_archs()) + sorted(
    tconfigs.opt_family.OPT_CONFIGS)
STRATEGIES = ("ddp", "zero1", "zero3", "tp")
BATCHES = (1, 2, 3, 4, 6, 8, 16, 32, 256)


def _flat_ref(tree):
    """Leaves of a reference pspec tree in jax's order, as tuples."""
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, P))
    return [tuple(p) for p in leaves]


def _flat_port(tree):
    """Leaves of a port pspec tree in jax's order (dict keys sorted,
    NamedTuple fields in order)."""
    if TS.is_pspec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_port(tree[k])]
    return [x for t in tree for x in _flat_port(t)]


def _cache_ref(struct):
    return jax.tree_util.tree_leaves(
        struct, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_port_pspecs_equal_the_reference(arch, strategy, mesh_id):
    mesh = FakeMesh(MESHES[mesh_id])
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)

    assert TS.rules_for(strategy, mesh) == JS.rules_for(strategy, mesh)
    assert TS.opt_rules_for(strategy, mesh) == JS.opt_rules_for(strategy,
                                                                mesh)
    assert TS.zero1_opt_rules(strategy, mesh) == JS.zero1_opt_rules(
        strategy, mesh)
    assert TS.data_axes(mesh) == JS.data_axes(mesh)

    # param pspecs: spec_to_pspec on every leaf of the model's tree
    got = _flat_port(TS.param_pspecs(tcfg, mesh, strategy))
    want = _flat_ref(JS.param_pspecs(jcfg, mesh, strategy))
    assert got == want

    # the value-head trees (critic / reward) through pspecs_for_tree
    for opt in (False, True):
        got = _flat_port(TS.pspecs_for_tree(TR.param_specs(tcfg), mesh,
                                            strategy, opt=opt))
        want = _flat_ref(JS.pspecs_for_tree(JR.param_specs(jcfg), mesh,
                                            strategy, opt=opt))
        assert got == want

    # train-state pspecs at ZeRO 0 and 1: params, m, v, step counters
    for zero in (0, 1):
        t = TS.train_state_pspecs(tcfg, mesh, strategy, zero=zero)
        j = JS.train_state_pspecs(jcfg, mesh, strategy, zero=zero)
        for a, b in ((t.params, j.params), (t.opt.m, j.opt.m),
                     (t.opt.v, j.opt.v)):
            assert _flat_port(a) == _flat_ref(b)
        assert t.step == tuple(j.step) == ()
        assert t.opt.step == tuple(j.opt.step) == ()

    # batch pspecs over batch sizes that do and do not divide the axes
    for batch in BATCHES:
        for ndim in (1, 2, 3):
            assert TS.batch_pspec(mesh, batch, ndim) == tuple(
                JS.batch_pspec(mesh, batch, ndim))

    # cache pspecs at a batch and length that shard and that do not
    for batch, length in ((32, 64), (3, 65), (4, 48)):
        got = _flat_port(TS.cache_pspecs(TT.cache_struct(tcfg, batch,
                                                         length), mesh,
                                         batch))
        want = [tuple(p) for p in _cache_ref(JS.cache_pspecs(
            JT.cache_struct(jcfg, batch, length), mesh, batch))]
        assert got == want


def test_placements_follow_the_pspec():
    """Shard(d) on the mesh dim an entry names, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"data": 2, "model": 2})
    assert TS.placements(("data", "model"), mesh) == (Shard(0), Shard(1))
    assert TS.placements((None, "data"), mesh) == (Shard(1), Replicate())
    assert TS.placements(("model", None), mesh) == (Replicate(), Shard(0))
    assert TS.placements((None, None), mesh) == (Replicate(), Replicate())
    assert TS.placements((("data",), None), mesh) == (Shard(0),
                                                      Replicate())
    sh = TS.param_shardings(tconfigs.get_config("opt-125m"), mesh, "zero3")
    assert sh["embed"].spec == TS.param_pspecs(
        tconfigs.get_config("opt-125m"), mesh, "zero3")["embed"]


def test_disaggregated_pieces_are_refused():
    """The cross-mesh put is a collective over the bridge between the
    disaggregated meshes (``tests/test_torch_disaggregated.py``): without
    one it is refused; with no target layout it is the identity, as in
    the reference."""
    tree = {"a": 1}
    assert TS.cross_mesh_put(tree, None) is tree
    with pytest.raises(ValueError, match="needs the bridge between the two "
                       "meshes"):
        TS.cross_mesh_put(tree, object())
