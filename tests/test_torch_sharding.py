"""The port's sharding specs (``repro_torch.distributed.sharding``) and
microbatch count (``train.steps``) against the JAX package's, for every
arch at its published size (``meta`` trees: no memory), on abstract
meshes: every spec tree equal leaf for leaf, as tuples. ``shard_leaf``
against ``NamedSharding`` is in tests/test_torch_distributed.py (it needs
a mesh of devices)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro.configs import optimized, shape_applicable  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import optimized as port_optimized  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402


class FakeMesh:
    """The abstract mesh of tests/test_distributed.py: axis sizes only."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}


def _ref(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port(tree):
    return [tuple(s) for s in shd.spec_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch: str):
    """The JAX package's ``eval_shape`` tree (``optimized`` changes no
    shape)."""
    return ref_lm.param_specs(get_config(arch))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, mesh):
    """param_pspecs (train and serve, the published flags and
    ``optimized``'s), batch_pspecs and decode_state_pspecs for every
    shape the arch runs, opt_state_pspecs and opt_specs (the arch's
    optimizer and the other two), and pick_grad_accum: each the JAX
    package's, leaf for leaf; the port's ``meta`` parameter tree has the
    shapes of the JAX package's ``eval_shape`` tree."""
    m = FakeMesh(MESHES[mesh])
    for flags in (False, True):
        rc, pc = get_config(arch), port_config(arch)
        if flags:
            rc, pc = optimized(rc), port_optimized(pc)
        pshapes = lm.param_specs(pc)
        assert [tuple(t.shape) for t in lm.tree_leaves(pshapes)] == [
            tuple(s.shape)
            for s in jax.tree.leaves(_ref_param_shapes(arch))]
        for serve in (False, True):
            want = ref_shd.param_pspecs(rc, m, serve=serve)
            got = shd.param_pspecs(pc, m, serve=serve)
            assert _port(got) == _ref(want), (flags, serve)
        # the optimizer state's specs from the train param specs
        want_p = ref_shd.param_pspecs(rc, m)
        got_p = shd.param_pspecs(pc, m)
        assert _port(shd.opt_state_pspecs(pc, m, got_p, pshapes)) == _ref(
            ref_shd.opt_state_pspecs(rc, m, want_p,
                                     _ref_param_shapes(arch)))
        for name in {rc.optimizer, "adamw", "adafactor", "sgd"}:
            got_o = steps.opt_specs(pc, m, opt.OptConfig(name=name), got_p)
            want_o = ref_steps.opt_specs(rc, m, ref_opt.OptConfig(name=name),
                                         want_p)
            assert _port(got_o) == _ref(want_o), name
        for shape in SHAPES.values():
            if not shape_applicable(rc, shape)[0]:
                continue
            got_b = shd.batch_pspecs(pc, shape, m)
            want_b = ref_shd.batch_pspecs(rc, shape, m)
            assert {k: tuple(v) for k, v in got_b.items()} == {
                k: tuple(v) for k, v in want_b.items()}, shape.name
            if shape.kind != "train":
                assert _port(shd.decode_state_pspecs(pc, shape, m)) == _ref(
                    ref_shd.decode_state_pspecs(rc, shape, m)), shape.name
            assert steps.pick_grad_accum(shape, m) == \
                ref_steps.pick_grad_accum(shape, m), shape.name


def test_grad_accum_and_specs_without_a_mesh():
    """``dist=None`` (one card): one dp rank, so train_4k takes
    ``pick_grad_accum`` = 256 / 2 microbatches of 8192 tokens, and every
    spec is replicated; a ``P`` canonicalises its entries as the JAX
    package's ``PartitionSpec`` does."""
    assert steps.pick_grad_accum(SHAPES["train_4k"], None) == 128
    assert steps.pick_grad_accum(SHAPES["train_4k"], FakeMesh(
        MESHES["16x16"])) == ref_steps.pick_grad_accum(
        SHAPES["train_4k"], FakeMesh(MESHES["16x16"])) == 8
    cfg = port_config("granite-moe-1b-a400m")
    assert all(set(s) <= {None} for s in shd.spec_leaves(
        shd.param_pspecs(cfg, None)))
    for parts in [(("a",),), ((),), (["a", "b"],), ("a", ("b",)), (None,)]:
        assert tuple(shd.P(*parts)) == tuple(JP(*parts))
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8)
    ts = steps.make_train_step(cfg, shape, None)
    assert ts.grad_accum == 4
    assert ts.out_shardings[2] == {k: () for k in (
        "loss", "aux", "tokens", "grad_norm", "lr")}


@pytest.mark.parametrize("moe_shard", ["ffn", "expert"])
def test_expert_blocks_run_only_under_ep_a2a(moe_shard):
    """Only ``moe_apply_ep`` computes on a rank's block of the experts:
    ``shard_experts`` refuses any other ``moe_shard``, and the dense
    ``moe_apply`` refuses expert leaves of fewer experts than the
    config's (it would otherwise reshape its E*C dispatch table over the
    block and return a wrong result without an error)."""
    from repro_torch.models import blocks as B
    cfg = dataclasses.replace(port_config("granite-moe-1b-a400m").reduced(),
                              compute_dtype="float32", moe_shard=moe_shard)
    with pytest.raises(ValueError, match="ep_a2a"):
        shd.shard_experts(lm.init(cfg, 0, device="cpu"), cfg, None)
    p = B.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 4, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, _ = B.moe_apply(p, cfg, x)
    assert y.shape == x.shape
    e = cfg.moe.n_experts // 2
    with pytest.raises(ValueError, match="experts"):
        B.moe_apply({k: v if k == "router" else v[:e]
                     for k, v in p.items()}, cfg, x)
