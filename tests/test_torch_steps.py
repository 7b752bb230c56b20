"""The port's ``train.steps.make_train_step`` with gradient accumulation
against the JAX package's, on one device: the same weights (the JAX
package's ``lm.init``, through numpy) and the same synthetic batch, in
f32 compute. The steps over a ``DistContext`` (data 2 x model 2) are in
tests/test_torch_distributed.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES, get_config  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.train import data as ref_D  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402

# 8 sequences of 32 tokens in GA microbatches of 2
SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=8)
GA = 4
LOSS_RTOL = 1e-5
# each leaf's gradient within GRAD_TOL x its largest |g|; the params
# after the step within UPDATE_TOL of each leaf's largest update, the
# optimizer state within STATE_TOL x its largest |value|
# (tests/test_torch_train.py's bounds)
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-2
STATE_TOL = 1e-4


def _share(got, want) -> float:
    """max |got - want| over GRAD_TOL x max |want|, the largest over the
    leaves."""
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               / (GRAD_TOL * float(np.abs(np.asarray(b)).max()))
               for a, b in zip(got, want))


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_grad_accum_matches_jax(arch):
    """``grad_accum=4``: the gradients the port accumulates in f32 over
    the 4 microbatches, over 4, against the JAX package's (the mean of
    ``jax.grad`` over the same microbatches, its ``lax.scan``); the loss
    and metrics, the params and the AdamW state after the step against
    its ``make_train_step`` jitted on a (1, 1) mesh. For smollm-135m the
    gradients are also within GRAD_TOL of ``jax.value_and_grad`` over the
    whole batch. granite-moe's are not, in either package: its aux loss
    is a product of two means over the tokens it routes, taken per
    microbatch (its router's gradient parts by ~0.12 of its largest)."""
    jcfg = dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(port_config(arch).reduced(),
                              compute_dtype="float32")
    params = ref_lm.init(jcfg, jax.random.key(0))
    batch = ref_D.SyntheticLM(ref_D.for_model(jcfg, SHAPE)).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.loss_fn(p, jcfg, b), has_aux=True))
    _, whole = grad(params, jb)
    rows = SHAPE.global_batch // GA
    micro = [grad(params, {k: v[i * rows:(i + 1) * rows]
                           for k, v in jb.items()})[1] for i in range(GA)]
    mean = jax.tree.map(lambda *g: sum(g) / GA, *micro)
    ts = ref_steps.make_train_step(jcfg, SHAPE, make_test_mesh((1, 1)),
                                   grad_accum=GA)
    oc = ref_opt.for_model(jcfg)
    want_p, want_o, want_m = jax.jit(
        ts.fn, in_shardings=ts.in_shardings,
        out_shardings=ts.out_shardings)(params, ref_opt.init(oc, params), jb)

    tree = jax.tree.map(np.asarray, params)
    step = steps.make_train_step(cfg, SHAPE, None, grad_accum=GA)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, _ = step.grads(lm.params_from_numpy(cfg, tree, device="cpu"), tb)
    got = [g.numpy() for g in lm.tree_leaves(grads)]
    assert _share(got, jax.tree.leaves(mean)) <= 1
    whole_share = _share(got, jax.tree.leaves(whole))
    if cfg.moe is None:
        assert whole_share <= 1
    else:
        assert whole_share > 1

    p = lm.params_from_numpy(cfg, tree, device="cpu")
    state = opt.init(opt.for_model(cfg), p)
    _, _, m = step.fn(p, state, tb)
    assert set(m) == set(want_m)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(want_m[k]),
                                   rtol=LOSS_RTOL)
    for a, b, b0 in zip(lm.tree_leaves(p), jax.tree.leaves(want_p),
                        jax.tree.leaves(params)):
        upd = float(np.abs(np.asarray(b) - np.asarray(b0)).max())
        assert float(np.abs(a.detach().numpy() - np.asarray(b)).max()) \
            <= UPDATE_TOL * upd
    for k in ("mu", "nu"):
        for a, b in zip(lm.tree_leaves(state[k]), jax.tree.leaves(
                want_o[k])):
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) \
                <= STATE_TOL * float(np.abs(np.asarray(b)).max())
    assert int(state["count"]) == int(want_o["count"]) == 1
