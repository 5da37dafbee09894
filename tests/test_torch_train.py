"""The port's training path against the JAX package's, on the CPU: the
chunked cross entropy, the backward passes of K2 and K3 (through the
plain versions the port runs here), ``loss_fn`` and every gradient,
AdamW, gradient compression and ``make_train_step``.  Inputs come from
NumPy with a seed; the reference's weights are carried across by
``params_from_numpy``.

Tolerances.  float32: rtol = atol = 2e-4, as the prefill tests use (the
same function in another summation order; the measured gap is about
5e-6 of each gradient's largest entry).  bfloat16: the loss within 1e-3
and each gradient within 10 % of its largest entry, 10 % relative L2:
both packages round every bf16 product, but XLA keeps fused bf16 chains
in float32 where PyTorch rounds each operation (measured: 3.2e-4 on the
loss, 7 % on zamba2's ``D_skip``, whose gradient sums B·T·P products
that cancel)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro.train import compression as ref_compression
from repro.train import optimizer as ref_optimizer
from repro.train import train_step as ref_train_step
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_online
from repro_torch.models import (ModelConfig, loss_fn, params_from_numpy,
                                params_to_numpy)
from repro_torch.models.convert import reference_ndim, tree_to_numpy
from repro_torch.models.layers import chunked_softmax_xent
from repro_torch.train import (AdamWConfig, TrainConfig, abstract_train_state,
                               adamw_update, init_opt_state,
                               init_train_state, lr_at, make_train_step)
from repro_torch.train import compression
from repro_torch.train.train_step import compute_params

F32 = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("zamba2-7b", "mamba2-2.7b", "qwen3-0.6b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side: keep torch's
    CPU ops on one thread each so they do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _flat(tree) -> dict[str, np.ndarray]:
    """A nested tree's leaves by "a/b/c" path, as float32 NumPy."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32) for path, leaf in flat}


def _reduced(arch: str, **overrides):
    ref = ref_get_config(arch).reduced(**overrides)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _batch(vocab: int, B: int = 2, S: int = 80, seed: int = 0):
    """tokens and labels (B, S); a few labels -1 (not counted)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    return tokens, labels


# ---------------------------------------------------------------------------
# the chunked cross entropy


@pytest.mark.parametrize("cap", [None, 30.0], ids=["no_softcap", "softcap"])
def test_chunked_softmax_xent_matches_reference(cap):
    """S 70 over chunks of 32 (two full chunks and a padded one), labels
    of -1 here and there, softcap on and off: the mean NLL and its
    gradients for the hidden states and the unembedding."""
    ref_cfg, cfg = _reduced("qwen3-0.6b", dtype="float32", loss_chunk=32)
    rng = np.random.default_rng(3)
    B, S, D, V = 2, 70, 48, 97
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    want, (dh_want, dw_want) = jax.value_and_grad(
        lambda h, u: ref_layers.chunked_softmax_xent(
            h, u, jnp.asarray(labels), ref_cfg, final_softcap=cap),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w))
    h_t, w_t = _t(hidden).requires_grad_(), _t(w).requires_grad_()
    got = chunked_softmax_xent(h_t, w_t, torch.from_numpy(labels), cfg,
                               final_softcap=cap)
    dh, dw = torch.autograd.grad(got, (h_t, w_t))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(dh), np.asarray(dh_want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(_np(dw), np.asarray(dw_want), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# K2 and K3 with their backward passes


FLASH_CASES = {
    "causal": dict(causal=True, window=None, cap=None, H=4, KV=4),
    "window": dict(causal=True, window=7, cap=None, H=4, KV=4),
    "softcap": dict(causal=True, window=None, cap=5.0, H=4, KV=4),
    "gqa": dict(causal=True, window=None, cap=None, H=6, KV=2),
    "gqa_window_softcap": dict(causal=True, window=9, cap=3.0, H=4, KV=2),
    "bidirectional": dict(causal=False, window=None, cap=None, H=4, KV=2),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_grads_match_reference(name):
    """``ops.flash_attention`` with inputs that require a gradient goes
    through ``FlashAttention``: its forward (the plain online version on
    the CPU), its ``lse`` and its backward
    (``flash_attention_bwd_plain``) against the reference's custom-VJP
    ``_flash`` and ``jax.grad``, over key blocks of 16 (T 40: three
    blocks, the last short)."""
    case = FLASH_CASES[name]
    H, KV, Dh, B, T, blk = case["H"], case["KV"], 16, 2, 40, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    ct = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    scale = 1.0 / np.sqrt(Dh)
    win = jnp.asarray(ref_layers.NO_WINDOW if case["window"] is None
                      else case["window"], jnp.int32)

    def ref_loss(q, k, v):
        out = ref_layers._flash(q.reshape(B, T, KV, H // KV, Dh), k, v, win,
                                case["causal"], scale, case["cap"], blk)
        return jnp.sum(out.reshape(B, T, H, Dh) * ct)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, lse_want = ref_layers._fa_forward(
        jnp.asarray(q).reshape(B, T, KV, H // KV, Dh), jnp.asarray(k),
        jnp.asarray(v), win, case["causal"], scale, case["cap"], blk)

    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=case["causal"],
                              window=case["window"], cap=case["cap"],
                              scale=scale, kv_block=blk)
    assert out.grad_fn is not None \
        and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad((out * _t(ct)).sum(), (qt, kt, vt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    _, lse = flash_attention_online(_t(q), _t(k), _t(v),
                                    causal=case["causal"],
                                    window=case["window"], cap=case["cap"],
                                    scale=scale, kv_block=blk,
                                    with_lse=True)
    assert lse.shape == (B, H, T)
    np.testing.assert_allclose(
        _np(lse), np.asarray(lse_want).reshape(B, T, H).transpose(0, 2, 1),
        rtol=1e-6, atol=1e-6)


def test_flash_attention_without_grad_takes_the_forward_alone():
    """No input requires a gradient, or grad mode is off: the plain call,
    no autograd node."""
    q = torch.randn(1, 12, 2, 8, requires_grad=True)
    assert ops.flash_attention(q.detach(), q.detach(), q.detach()).grad_fn \
        is None
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_scan_grads_match_reference(G):
    """``ops.ssd_scan`` through ``SSDScan`` (forward: the plain chunk
    loop; backward: that loop recomputed and differentiated) against
    ``jax.grad`` of the reference's ``ssd_chunked`` (superchunks of 2),
    over 6 chunks of 8, on the model's dt and A ramps: the gradients of
    x, dt, A, B and C."""
    B, T, H, P, N, chunk = 2, 48, 4, 8, 16, 8
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, T, H))
                ).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    ct = rng.standard_normal((B, T, H, P)).astype(np.float32)

    def ref_loss(*args):
        y, _ = ref_ssm.ssd_chunked(*args, chunk, superchunk=2)
        return jnp.sum(y * ct)
    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    ins = [_t(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    y = ops.ssd_scan(*ins, chunk=chunk)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    got = torch.autograd.grad((y * _t(ct)).sum(), ins)
    for name, g, w in zip("x dt A B C".split(), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_ssd_scan_grads_finite_where_the_reference_overflows():
    """At a full-width chunk (128 tokens) on a head with A = -16 and dt
    0.1, the decay's exponent above the diagonal reaches +203 and
    overflows float32: the reference's ``where(tri, exp(L), 0)`` then
    has NaN gradients (0 · inf), while the port masks the exponent first.
    Its gradients are finite and equal the reference's at chunk 16, where
    nothing overflows (the chunking does not change the function)."""
    B, T, H, P, N = 1, 128, 2, 4, 8
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.full((B, T, H), 0.1, np.float32)
    A = np.array([-1.0, -16.0], np.float32)
    Bm = rng.standard_normal((B, T, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, 1, N)).astype(np.float32)

    def ref_grads(chunk):
        return jax.grad(lambda *a: jnp.sum(ref_ssm.ssd_chunked(
            *a, chunk)[0]), argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    assert np.isnan(np.asarray(ref_grads(128)[1])).any()
    ins = [_t(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    got = torch.autograd.grad(ops.ssd_scan(*ins, chunk=128).sum(), ins)
    for name, g, w in zip("x dt A B C".split(), got, ref_grads(16)):
        assert bool(torch.isfinite(g).all()), name
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_ssd_scan_grads_for_some_inputs_only():
    """Only the inputs that require a gradient get one."""
    x = torch.randn(1, 16, 2, 4, requires_grad=True)
    dt = torch.rand(1, 16, 2) * 0.1
    A = -torch.ones(2)
    Bm, Cm = torch.randn(1, 16, 1, 8), torch.randn(1, 16, 1, 8)
    (gx,) = torch.autograd.grad(ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
                                .sum(), (x,))
    assert gx.shape == x.shape and bool(torch.isfinite(gx).all())


# ---------------------------------------------------------------------------
# loss_fn


def _loss_pair(arch: str, dtype: str, **overrides):
    """The reference's loss and gradients with respect to its compute
    parameters (cast once to ``dtype`` for ndim >= 2, as its train step
    does) against the port's through ``compute_params``."""
    ref_cfg, cfg = _reduced(arch, dtype=dtype, **overrides)
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0))
    tokens, labels = _batch(ref_cfg.vocab_size)
    compute = jax.tree.map(
        lambda p: p.astype(ref_cfg.dtype) if p.ndim >= 2 else p, params)
    want, grads = jax.jit(jax.value_and_grad(ref_lm.loss_fn),
                          static_argnums=2)(
        compute, {"tokens": jnp.asarray(tokens),
                  "labels": jnp.asarray(labels)}, ref_cfg)
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    cp = compute_params(model)
    got = loss_fn(model, {"tokens": torch.from_numpy(tokens),
                          "labels": torch.from_numpy(labels)}, cp)
    g = torch.autograd.grad(got, list(cp.values()))
    got_grads = _flat(tree_to_numpy({n: t.float()
                                     for n, t in zip(cp, g)}))
    return (float(want), float(got.detach()), _flat(grads), got_grads,
            model, cp)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference_float32(arch):
    """Reduced config, float32: the loss and every gradient leaf within
    2e-4; S 80 over loss chunks of 64 (one padded)."""
    want, got, want_g, got_g, _, _ = _loss_pair(arch, "float32")
    np.testing.assert_allclose(got, want, **F32)
    assert set(got_g) == set(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], **F32,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference_bfloat16(arch):
    """Reduced config, bf16 compute over float32 masters: the compute
    tensors are bf16 exactly where the reference's leaf has two or more
    dimensions (every per-layer leaf, which it stacks); the loss within
    1e-3 and each gradient within the module docstring's bf16 bound."""
    want, got, want_g, got_g, model, cp = _loss_pair(arch, "bfloat16")
    for name, t in cp.items():
        stacked = name.startswith("layers.")
        assert t.dtype == (torch.bfloat16 if stacked or t.dim() >= 2
                           else torch.float32), name
    assert abs(got - want) < 1e-3
    for name in want_g:
        w, g = want_g[name], got_g[name]
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 0.1 * scale, name
        assert float(np.linalg.norm(g - w)) <= 0.1 * float(
            np.linalg.norm(w)), name


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_changes_no_value(remat):
    """``remat="none"`` and ``"dots"`` (selective checkpointing of the
    projections) give the loss and gradients of ``"full"``, every
    config's default, on the hybrid (whose shared block sits inside its
    layer's checkpoint)."""
    outs = {}
    for mode in ("full", remat):
        _, cfg = _reduced("zamba2-7b", dtype="float32", remat=mode)
        ref_cfg = ref_get_config("zamba2-7b").reduced(dtype="float32")
        params = jax.tree.map(np.asarray, ref_lm.init_params(
            ref_cfg, jax.random.PRNGKey(0)))
        model = params_from_numpy(cfg, params, device="cpu")
        tokens, labels = _batch(cfg.vocab_size)
        cp = compute_params(model)
        loss = loss_fn(model, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)}, cp)
        outs[mode] = [loss.detach()] + list(torch.autograd.grad(
            loss, list(cp.values())))
    for a, b in zip(outs["full"], outs[remat]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_loss_fn_on_the_models_own_parameters():
    """Without ``params`` the loss reads the model's own parameters; in
    float32 the value equals the one on ``compute_params``."""
    _, cfg = _reduced("qwen3-0.6b", dtype="float32", n_layers=1)
    from repro_torch.models import build_model
    model = build_model(cfg, seed=0, device="cpu")
    tokens, labels = _batch(cfg.vocab_size, S=20)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        own = loss_fn(model, batch)
        cp = loss_fn(model, batch, compute_params(model))
    assert float(own) == float(cp)
    with pytest.raises(KeyError, match="missing"):
        loss_fn(model, batch, {"embed": model.embed})


# ---------------------------------------------------------------------------
# the optimizer and compression


def test_lr_at_matches_reference():
    cfg = AdamWConfig()
    ref = ref_optimizer.AdamWConfig()
    for step in (0, 1, 99, 100, 5_000, 10_000, 20_000):
        got = lr_at(cfg, step)
        assert got.dtype == torch.float32
        assert float(got) == float(ref_optimizer.lr_at(
            ref, jnp.asarray(step, jnp.int32))), step


def _stacked_trees(L=3, D=8, F=5, V=11, seed=0):
    """The reference's tree (layers stacked) and the port's flat dict of
    the same values, with per-layer 1-D leaves, a stacked matrix, an
    unstacked 1-D ``final_norm`` and a shared block's 1-D ``ln1``."""
    rng = np.random.default_rng(seed)
    ref = {"embed": rng.standard_normal((V, D)),
           "final_norm": rng.standard_normal(D),
           "layers": {"ln": rng.standard_normal((L, D)),
                      "A_log": rng.standard_normal((L, 2)),
                      "w": rng.standard_normal((L, D, F))},
           "shared": {"ln1": rng.standard_normal(D),
                      "wq": rng.standard_normal((D, 2, 4))}}
    ref = jax.tree.map(lambda a: a.astype(np.float32), ref)
    port = {"embed": ref["embed"], "final_norm": ref["final_norm"],
            "shared.ln1": ref["shared"]["ln1"],
            "shared.wq": ref["shared"]["wq"]}
    for i in range(L):
        for leaf in ("ln", "A_log", "w"):
            port[f"layers.{i}.{leaf}"] = ref["layers"][leaf][i]
    return ref, {k: _t(v) for k, v in port.items()}


def test_adamw_update_decays_by_the_reference_shape():
    """Three AdamW steps on a tree with stacked 1-D leaves against the
    reference's: every per-layer leaf is decayed (its reference leaf is
    2-D), ``final_norm`` and the shared block's ``ln1`` are not; params,
    moments, count and metrics agree."""
    cfg, ref_cfg = AdamWConfig(lr=0.1, warmup_steps=1), \
        ref_optimizer.AdamWConfig(lr=0.1, warmup_steps=1)
    ref_p, port_p = _stacked_trees()
    assert [n for n, t in port_p.items() if reference_ndim(n, t) < 2] \
        == ["final_norm", "shared.ln1"]
    ref_opt = ref_optimizer.init_opt_state(ref_p)
    opt = init_opt_state(port_p)
    for s in range(3):
        ref_g, port_g = _stacked_trees(seed=10 + s)
        ref_p, ref_opt, ref_m = jax.jit(ref_optimizer.adamw_update,
                                        static_argnums=0)(
            ref_cfg, ref_g, ref_opt, ref_p)
        port_p, opt, m = adamw_update(cfg, port_g, opt, port_p)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                       rtol=1e-6)
    assert int(opt["count"]) == int(ref_opt["count"]) == 3
    for got, want in ((port_p, ref_p), (opt["mu"], ref_opt["mu"]),
                      (opt["nu"], ref_opt["nu"])):
        got_f, want_f = _flat(tree_to_numpy(got)), _flat(want)
        for name in want_f:
            np.testing.assert_allclose(got_f[name], want_f[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    # the decay alone: zero gradients leave step = 0
    _, p0 = _stacked_trees()
    p1 = {k: v.clone() for k, v in p0.items()}
    adamw_update(cfg, {k: torch.zeros_like(v) for k, v in p0.items()},
                 init_opt_state(p1), p1)
    lr = float(lr_at(cfg, 1))
    for name in p0:
        decayed = reference_ndim(name, p0[name]) >= 2
        want = p0[name] * (1 - lr * cfg.weight_decay) if decayed \
            else p0[name]
        torch.testing.assert_close(p1[name], want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compression_with_error_feedback_matches_reference(method):
    """Three rounds of error feedback on the stacked trees: one int8
    scale, or one top-k threshold, per reference leaf across its layers
    (not per port tensor); ties at the threshold all kept.  The sent
    gradients and the residuals agree with the reference's."""
    ref_ef = ref_compression.EFState.init(_stacked_trees()[0])
    ef = compression.EFState.init(_stacked_trees()[1])
    for s in range(3):
        ref_g, port_g = _stacked_trees(seed=20 + s)
        if method == "topk":               # ties at the threshold
            for i in range(3):
                port_g[f"layers.{i}.w"][0, :] = 2.5
            ref_g["layers"]["w"][:, 0, :] = 2.5
        ref_sent, ref_ef = ref_compression.compress_with_error_feedback(
            ref_g, ref_ef, method=method, topk_frac=0.1)
        sent, ef = compression.compress_with_error_feedback(
            port_g, ef, method=method, topk_frac=0.1)
        for got, want in ((sent, ref_sent), (ef.residual, ref_ef.residual)):
            got_f, want_f = _flat(tree_to_numpy(got)), _flat(want)
            for name in want_f:
                np.testing.assert_allclose(got_f[name], want_f[name],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=name)
    assert compression.compressed_bytes_ratio(method, 0.1) \
        == ref_compression.compressed_bytes_ratio(method, 0.1)
    with pytest.raises(ValueError):
        compression.compress_decompress({"w": torch.ones(2)}, "fp8")


# ---------------------------------------------------------------------------
# make_train_step


@pytest.mark.parametrize("microbatches,method",
                         [(1, "none"), (2, "none"), (1, "int8"),
                          (2, "int8")])
def test_make_train_step_matches_reference(microbatches, method):
    """Three steps of reduced qwen3-0.6b (float32) against the
    reference's jitted step: the metrics, ``count`` and ``step``, and the
    parameters and moments.  Under int8 compression a gradient that sits
    within rounding of a quantization boundary may take the neighbouring
    level in one package, one level being max|g| / 127 of the leaf: an
    entry of ``mu`` then moves by (1 - b1) times a level, one of ``nu``
    by about (1 - b2) · 2 max|g| times a level, a few hundredths of the
    moment's largest entry over three steps.  The moments are held to
    4 / 127 of their largest entry and the share of entries beyond 2e-4
    to 1 %; the parameters (lr 3e-6 to 9e-6) and metrics to 2e-4."""
    ref_cfg, cfg = _reduced("qwen3-0.6b", dtype="float32")
    ref_state = ref_train_step.init_train_state(ref_cfg,
                                                jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                ref_state["params"]),
                              device="cpu")
    state = init_train_state(cfg, model=model)
    ref_step = jax.jit(ref_train_step.make_train_step(
        ref_cfg, ref_train_step.TrainConfig(microbatches=microbatches,
                                            compression=method)))
    step = make_train_step(cfg, TrainConfig(microbatches=microbatches,
                                            compression=method))
    rng = np.random.default_rng(1)
    for _ in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (4, 48)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        ref_state, ref_m = ref_step(ref_state, {
            "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens),
                                "labels": torch.from_numpy(labels)})
        assert set(m) == set(ref_m)
        for key in m:
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                       rtol=1e-5, err_msg=key)
    assert int(state["opt"]["count"]) == int(ref_state["opt"]["count"]) \
        == int(state["step"]) == int(ref_state["step"]) == 3
    assert state["step"].dtype == state["opt"]["count"].dtype == torch.int32
    got = {"params": params_to_numpy(state["params"]),
           "mu": tree_to_numpy(state["opt"]["mu"]),
           "nu": tree_to_numpy(state["opt"]["nu"])}
    want = {"params": ref_state["params"], "mu": ref_state["opt"]["mu"],
            "nu": ref_state["opt"]["nu"]}
    got_f, want_f = _flat(got), _flat(want)
    assert set(got_f) == set(want_f)
    for name in want_f:
        g, w = got_f[name], want_f[name]
        if method == "none" or name.startswith("params/"):
            np.testing.assert_allclose(g, w, **F32, err_msg=name)
            continue
        bound = 4 * float(np.abs(w).max()) / 127
        assert float(np.abs(g - w).max()) <= bound, name
        assert float(np.mean(~np.isclose(g, w, **F32))) <= 0.01, name


def test_abstract_train_state_is_on_the_meta_device():
    """Shapes and dtypes, no storage: the moments mirror the parameters
    in float32, ``count`` and ``step`` are int32 scalars."""
    from repro_torch.configs import get_config
    state = abstract_train_state(get_config("mamba2-2.7b"))
    params = dict(state["params"].named_parameters())
    assert sum(p.numel() for p in params.values()) == 2_702_579_200
    for moment in ("mu", "nu"):
        assert {n: (t.shape, t.dtype, t.device.type)
                for n, t in state["opt"][moment].items()} \
            == {n: (p.shape, torch.float32, "meta")
                for n, p in params.items()}
    assert state["step"].dtype == state["opt"]["count"].dtype == torch.int32
    assert state["step"].device.type == "meta"
