"""The port's RNN cells and weight norm against the JAX package on the CPU.

The cases of ``tests/test_aux_modules.py:24-92`` are mirrored (weight norm
reconstructs, normalizes and is fp16-safe; the LSTM/GRU stacks' shapes and
grads; the LSTM against a manual step; the mLSTM runs). Every cell type
(RNN ReLU, RNN tanh, LSTM, GRU, mLSTM) then runs as a 2-layer stack on the
JAX ``RNN.init`` tree (``params_from_numpy``) beside ``RNN.apply``: the
outputs, each layer's final state, and the grads of every weight and of the
input under a fixed projection of the outputs within 1e-5 (fp32, another
summation order through 7 steps). Weight norm's pairs and dense weights
agree with the JAX functions within 1e-6, the grads through
``materialize_weight_norm`` within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import rnn as jrnn
from apex_tpu import reparameterization as jwn
from apex_tpu_torch import rnn
from apex_tpu_torch.reparameterization import (
    apply_weight_norm,
    materialize_weight_norm,
    norm_along,
    remove_weight_norm,
    weight_norm,
)

TOL = 1e-5
CELLS = ["RNNReLUCell", "RNNTanhCell", "LSTMCell", "GRUCell", "mLSTMCell"]


# -- weight norm --------------------------------------------------------------

def test_weight_norm_reconstructs_and_normalizes():
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    params = apply_weight_norm({"layer": {"kernel": w,
                                          "bias": torch.zeros(4)}})
    assert set(params["layer"]["kernel"]) == {"v", "g"}
    assert params["layer"]["bias"].shape == (4,)  # 1-D: not matched
    dense = materialize_weight_norm(params)
    torch.testing.assert_close(dense["layer"]["kernel"], w, rtol=1e-5,
                               atol=1e-6)
    # doubling g doubles the weight; v's own scale cancels
    p2 = {"layer": {"kernel": {"v": params["layer"]["kernel"]["v"] * 7.0,
                               "g": params["layer"]["kernel"]["g"] * 2.0},
                    "bias": params["layer"]["bias"]}}
    torch.testing.assert_close(materialize_weight_norm(p2)["layer"]
                               ["kernel"], 2 * w, rtol=1e-5, atol=1e-6)
    assert remove_weight_norm(params)["layer"]["kernel"].shape == (8, 4)


def test_weight_norm_fp16_safe():
    """The norm runs in fp32 for half inputs: each square of 100 is 1e4,
    and their sum overflows fp16 (the reference's fp16-safe norm)."""
    w = (torch.ones(4, 4) * 100).to(torch.float16)
    n = norm_along(w)
    torch.testing.assert_close(n, torch.full((4,), 200.0), rtol=1e-3,
                               atol=0)
    out = weight_norm(w, torch.ones(4) * 200.0)
    assert out.dtype == torch.float16 and torch.isfinite(out.float()).all()


def _wn_tree(rng):
    return {"layer": {"kernel": rng.normal(size=(6, 4)).astype(np.float32),
                      "bias": rng.normal(size=(4,)).astype(np.float32)},
            "emb": {"weight": rng.normal(size=(5, 3)).astype(np.float32)},
            "vec": {"kernel": rng.normal(size=(4,)).astype(np.float32)},
            "conv": {"kernel": rng.normal(size=(3, 2, 4)).astype(
                np.float32)}}


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_matches_jax(dim):
    """The same leaves become pairs, the pairs and the dense weights agree,
    and so do the grads of ``v`` and ``g`` through the rebuild."""
    tree = _wn_tree(np.random.default_rng(dim))
    jp = jwn.apply_weight_norm(jax.tree.map(jnp.asarray, tree), dim=dim)
    tp = apply_weight_norm(jax.tree.map(torch.from_numpy, tree), dim=dim)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6, err_msg=str(path))
    proj = {k: np.random.default_rng(9).normal(size=v["kernel"].shape
                                               if "kernel" in v else
                                               v["weight"].shape)
            for k, v in tree.items()}

    def loss_j(p):
        d = jwn.materialize_weight_norm(p, dim)
        return sum(jnp.sum(d[k]["kernel" if "kernel" in d[k] else "weight"]
                           * proj[k]) for k in d)

    jg = jax.grad(loss_j)(jp)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    d = materialize_weight_norm(tp, dim)
    loss = sum(torch.sum(d[k]["kernel" if "kernel" in d[k] else "weight"]
                         * torch.from_numpy(proj[k]).float()) for k in d)
    loss.backward()
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 jax.tree_util.tree_flatten_with_path(tp)[0]):
        got = b.grad if b.grad is not None else torch.zeros_like(b)
        np.testing.assert_allclose(got.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))


def test_weight_norm_custom_match():
    tree = {"a": {"kernel": torch.ones(2, 2)}, "b": {"w": torch.ones(3, 2)}}
    out = apply_weight_norm(tree, match=lambda path, leaf: path[0] == "b")
    assert isinstance(out["a"]["kernel"], torch.Tensor)
    assert set(out["b"]["w"]) == {"v", "g"}


# -- RNN ----------------------------------------------------------------------

@pytest.mark.parametrize("factory", [rnn.make_lstm, rnn.make_gru])
def test_rnn_shapes_and_gradients(factory):
    net = factory(6, 8, num_layers=2, device="cpu")
    x = torch.randn(3, 5, 6, generator=torch.Generator().manual_seed(1))
    out, finals = net(x)
    assert out.shape == (3, 5, 8) and len(finals) == 2
    loss = torch.sum(torch.square(out))
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in net.parameters())


def test_lstm_matches_manual_step():
    cell = rnn.LSTMCell(4, 4, device="cpu")
    x = torch.randn(2, 1, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cell.b.copy_(torch.linspace(-1, 1, 16))
        out, [(h, c)] = rnn.RNN([cell])(x)
    z = x[:, 0] @ cell.w_ih + torch.zeros(2, 4) @ cell.w_hh + cell.b
    i, f, g, o = torch.chunk(z.detach(), 4, dim=-1)
    c_ref = torch.sigmoid(i) * torch.tanh(g)
    h_ref = torch.sigmoid(o) * torch.tanh(c_ref)
    torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[:, 0], h_ref, rtol=1e-5, atol=1e-6)


def test_mlstm_runs():
    net = rnn.RNN([rnn.mLSTMCell(5, 7, device="cpu")])
    out, _ = net(torch.randn(2, 6, 5))
    assert out.shape == (2, 6, 7)


def _pair(name, bias=True, dropout=0.0):
    jcells = [getattr(jrnn, name)(6, 8, bias), getattr(jrnn, name)(8, 8,
                                                                   bias)]
    jnet = jrnn.RNN(jcells, dropout)
    jp = jnet.init(jax.random.PRNGKey(0))
    tnet = rnn.RNN([getattr(rnn, name)(6, 8, bias, device="cpu"),
                    getattr(rnn, name)(8, 8, bias, device="cpu")], dropout)
    tnet.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jnet, jp, tnet


def _flat_state(finals):
    out = []
    for s in finals:
        out += list(s) if isinstance(s, tuple) else [s]
    return out


@pytest.mark.parametrize("name,bias", [(n, True) for n in CELLS]
                         + [("LSTMCell", False), ("GRUCell", False)])
def test_cells_match_jax(name, bias):
    jnet, jp, tnet = _pair(name, bias)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)
    proj = rng.normal(size=(3, 7, 8)).astype(np.float32)
    hproj = rng.normal(size=(3, 8)).astype(np.float32)

    def loss_j(p, x):
        out, finals = jnet.apply(p, x)
        return jnp.sum(out * proj) + jnp.sum(
            _flat_state(finals)[-1] * hproj)

    jout, jfinals = jnet.apply(jp, jnp.asarray(x))
    jgp, jgx = jax.grad(loss_j, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, finals = tnet(xt)
    loss = torch.sum(out * torch.from_numpy(proj)) + torch.sum(
        _flat_state(finals)[-1] * torch.from_numpy(hproj))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL)
    for a, b in zip(_flat_state(finals), _flat_state(jfinals)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=TOL)
    for cell, jg in zip(tnet.cells, jgp):
        names = {n for n, _ in cell.named_parameters()}
        assert names == set(jg)
        for n, p in cell.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[n]),
                                       atol=TOL, err_msg=f"{name} {n}")


def test_gru_bias_joins_the_input_projection_only():
    """With zero weights the candidate is tanh(b_n): the bias went through
    the input projection, not through the reset gate."""
    cell = rnn.GRUCell(2, 3, device="cpu")
    with torch.no_grad():
        cell.w_ih.zero_()
        cell.w_hh.zero_()
        cell.b.copy_(torch.tensor([5.0] * 3 + [0.0] * 3 + [0.7] * 3))
    h = cell(torch.ones(1, 3), torch.zeros(1, 2))
    n = torch.tanh(torch.tensor(0.7))
    torch.testing.assert_close(h, torch.full((1, 3), 0.5 * float(n) + 0.5))


def test_rnn_dropout_comes_from_the_generator():
    _, _, net = _pair("LSTMCell", dropout=0.5)
    x = torch.randn(2, 4, 6, generator=torch.Generator().manual_seed(3))
    plain, _ = net(x)
    _, _, net0 = _pair("LSTMCell", dropout=0.0)
    assert torch.equal(plain, net0(x)[0])  # no generator: no dropout

    def run(seed):
        return net(x, dropout_generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1)[0], run(1)[0], run(2)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)
    one = rnn.RNN([rnn.LSTMCell(6, 8, device="cpu")], dropout=0.5)
    assert torch.equal(one(x)[0], one(
        x, dropout_generator=torch.Generator().manual_seed(1))[0])


def test_cells_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rnn.make_lstm(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rnn.GRUCell(2, 2)
    with pytest.raises(ValueError, match="trees for"):
        rnn.make_gru(2, 2, 2, device="cpu").params_from_numpy([{}])
