"""The port's mixture-of-experts FFN against the JAX package's.

``dense_switch_moe`` (index form) and the JAX one see the same float32
inputs from a seeded numpy generator: token choice at top-1 and top-2
and expert choice, over 1 and 2 slices, at a capacity factor that
overflows (0.5) and one that does not (2.0). Outputs and aux agree at
atol 1e-5 (float32 accumulation order), gradients of router, experts and
input at atol 1e-4. The index form equals the port's one-hot plain
version bit for bit in which pairs it keeps, where, and with what gate;
crafted inputs force ties and capacity overflow. The MoE LM (2 layers,
d_model 64, 4 experts, top-2, float32) through the converted flax
weights: logits and aux at atol 1e-4, the LM loss too.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.models import moe as jmoe
from adaptdl_tpu.models.transformer import apply_with_moe_aux as jax_apply
from adaptdl_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss_fn
from adaptdl_tpu_torch.models import moe
from adaptdl_tpu_torch.models.transformer import apply_with_moe_aux
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401


N, D, F_, E = 32, 8, 16, 4
ROUTERS = [("tokens", 1), ("tokens", 2), ("experts", 1)]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(D, E)).astype(np.float32),
        (0.3 * rng.normal(size=(E, D, F_))).astype(np.float32),
        (0.3 * rng.normal(size=(E, F_, D))).astype(np.float32),
    )


def _jax(x, router, w_up, w_down, **kw):
    return jmoe.dense_switch_moe(
        jnp.asarray(router), {"w_up": jnp.asarray(w_up), "w_down": jnp.asarray(w_down)},
        jnp.asarray(x), return_aux=True, **kw,
    )


def _port(x, router, w_up, w_down, fn=moe.dense_switch_moe, **kw):
    return fn(
        torch.tensor(router), {"w_up": torch.tensor(w_up), "w_down": torch.tensor(w_down)},
        torch.tensor(x), return_aux=True, **kw,
    )


def _kw(router, top_k, slices, factor):
    return dict(router_type=router, top_k=top_k, num_slices=slices,
                capacity_factor=factor)


@pytest.mark.parametrize("factor", [0.5, 2.0])
@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("router, top_k", ROUTERS)
def test_dense_switch_moe_matches_jax(router, top_k, slices, factor):
    args = _inputs()
    kw = _kw(router, top_k, slices, factor)
    want, want_aux = _jax(*args, **kw)
    got, aux = _port(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-5)
    if factor < 1:
        # Overflow: some tokens pass through unchanged, in both.
        passed = np.all(np.asarray(want) == args[0], axis=1)
        assert passed.any() and np.array_equal(passed, np.all(got.numpy() == args[0], axis=1))


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("router, top_k", ROUTERS)
def test_gradients_match_jax(router, top_k, slices):
    x, r, wu, wd = _inputs(seed=1)
    g = np.random.default_rng(2).normal(size=(N, D)).astype(np.float32)
    kw = _kw(router, top_k, slices, 0.5)

    def jloss(x, r, wu, wd):
        out, aux = jmoe.dense_switch_moe(
            r, {"w_up": wu, "w_down": wd}, x, return_aux=True, **kw
        )
        return jnp.sum(out * g) + aux

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, r, wu, wd)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, r, wu, wd)]
    out, aux = moe.dense_switch_moe(
        leaves[1], {"w_up": leaves[2], "w_down": leaves[3]}, leaves[0],
        return_aux=True, **kw,
    )
    ((out * torch.tensor(g)).sum() + aux).backward()
    for name, leaf, w in zip(("x", "router", "w_up", "w_down"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("factor", [0.5, 2.0])
@pytest.mark.parametrize("router, top_k", ROUTERS)
def test_index_form_equals_the_onehot_plain_version(router, top_k, factor):
    x, r, wu, wd = (torch.tensor(a) for a in _inputs(seed=3))
    cap = moe.capacity(router, factor, top_k, N, E)
    routing = moe.route(x, r, E, cap, top_k, router)
    if router == "experts":
        dispatch, combine, aux = moe.expert_choice_routing_onehot(x, r, E, cap)
    else:
        dispatch, combine, aux = moe.routing_onehot(x, r, E, cap, top_k)
    got_dispatch, got_combine = moe.onehot_from_routing(routing, N, E, cap)
    assert torch.equal(got_dispatch, dispatch)
    assert torch.equal(got_combine, combine.detach())
    assert torch.equal(routing.aux, aux)
    kw = _kw(router, top_k, 1, factor)
    got, _ = _port(*_inputs(seed=3), **kw)
    want, _ = _port(*_inputs(seed=3), fn=moe.dense_switch_moe_reference, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("router, top_k", ROUTERS)
def test_ties_and_overflow_route_as_jax(router, top_k):
    """A zero router makes every probability equal: token choice takes
    experts 0, 1, ... in turn (the first maximum), expert choice takes
    the lowest token indices; a capacity of N/8 per expert drops most
    pairs, whose tokens pass through unchanged."""
    x, _, wu, wd = _inputs(seed=4)
    r = np.zeros((D, E), np.float32)
    kw = _kw(router, top_k, 1, 0.5)
    want, want_aux = _jax(x, r, wu, wd, **kw)
    got, aux = _port(x, r, wu, wd, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)
    cap = moe.capacity(router, 0.5, top_k, N, E)
    routing = moe.route(torch.tensor(x), torch.tensor(r), E, cap, top_k, router)
    if router == "experts":
        assert torch.equal(routing.token.view(E, cap), torch.arange(cap).expand(E, cap))
    else:
        # Every token's first choice is expert 0 (its second expert 1):
        # the first ``cap`` tokens fill expert 0, the rest drop there.
        first = routing.kept.view(N, top_k)[:, 0]
        assert torch.equal(first, torch.arange(N) < cap)
        assert torch.equal(routing.slot.view(N, top_k)[:cap, 0], torch.arange(cap))
    routed = np.zeros(N, bool)
    routed[routing.token[routing.kept & (routing.weight > 0)].numpy()] = True
    np.testing.assert_array_equal(got.numpy()[~routed], x[~routed])


@pytest.mark.parametrize(
    "args",
    [("tokens", 2.0, 1, 64, 8), ("tokens", 1.25, 2, 100, 8), ("tokens", 0.1, 1, 4, 8),
     ("experts", 2.0, 1, 64, 8), ("experts", 9.0, 2, 16, 4), ("experts", 0.01, 1, 16, 4)],
)
def test_capacity_matches_jax(args):
    assert moe.capacity(*args) == jmoe._capacity(*args)


def test_unknown_router_raises_in_both():
    for fn in (moe.capacity, jmoe._capacity):
        with pytest.raises(ValueError, match="unknown router_type"):
            fn("nope", 2.0, 1, 16, 4)


SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=64, d_ff=64)
MOE = dict(moe_every_n=1, moe_num_experts=4, moe_top_k=2)


@functools.lru_cache(maxsize=None)
def _jax_moe_lm():
    return jax_init(
        JaxConfig(**SIZES, **MOE, max_seq_len=16, dtype=jnp.float32, remat=False),
        seq_len=16,
    )


def _port_moe_lm(**kw):
    _, params = _jax_moe_lm()
    model = TransformerLM(TransformerConfig(**SIZES, **MOE, dtype=torch.float32, **kw))
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return model


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 64, (2, 17), dtype=np.int32)


def test_moe_lm_logits_and_aux_match_flax():
    jax_model, params = _jax_moe_lm()
    model = _port_moe_lm(remat=False)
    inputs = _tokens()[:, :-1]
    want, want_aux = jax_apply(jax_model, params, jnp.asarray(inputs), jax.random.key(0))
    with torch.no_grad():
        got, aux = apply_with_moe_aux(model, torch.from_numpy(inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-4)
    assert float(aux) > 0


def test_moe_lm_loss_and_gradients_match_flax():
    jax_model, params = _jax_moe_lm()
    model = _port_moe_lm(remat=True)
    tokens = _tokens(seed=1)

    def jax_loss(p):
        logits, aux = jax_apply(jax_model, p, jnp.asarray(tokens[:, :-1]), jax.random.key(0))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(tokens[:, 1:])
        ).mean() + aux

    want, grads = jax.value_and_grad(jax_loss)(params)
    loss = lm_loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-4)
    want_grads = flax_to_state_dict(jax.device_get(grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), atol=1e-4, err_msg=name
        )


def test_expert_choice_is_refused_on_a_causal_model_in_both():
    with pytest.raises(ValueError, match="not causally valid"):
        TransformerConfig(**SIZES, **MOE, moe_router="experts")
    with pytest.raises(ValueError, match="not causally valid"):
        jax_init(JaxConfig(**SIZES, **MOE, max_seq_len=16, moe_router="experts"), seq_len=16)
    TransformerConfig(**SIZES, **MOE, moe_router="experts", causal=False)


def test_moe_blocks_and_their_init():
    """Every moe_every_n-th block holds router and experts (float32, the
    flax shapes) in place of the dense FFN; the initial weights follow
    flax's initialisers."""
    from adaptdl_tpu_torch.models import init_transformer

    cfg = TransformerConfig(**{**SIZES, "num_layers": 4}, moe_every_n=2, moe_num_experts=4)
    model = init_transformer(cfg, seed=0, device="cpu")
    assert [hasattr(b, "moe") for b in model.layers] == [False, True, False, True]
    block = model.layers[1].moe
    assert block.router.shape == (64, 4) and block.w_up.shape == (4, 64, 64)
    assert block.w_down.shape == (4, 64, 64) and block.w_up.dtype == torch.float32
    assert abs(block.router.std().item() - 0.02) < 0.004
    # flax's fan-in over [E, in, out] counts the experts: 1 / (E * in).
    assert abs(block.w_up.std().item() - (1 / (4 * 64)) ** 0.5) < 0.01
