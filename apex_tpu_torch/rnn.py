"""RNN, LSTM, GRU and mLSTM cells and their stacked runner (port of
``apex_tpu/rnn.py``; apex's deprecated ``apex/RNN``, kept for its API).

Each cell is an ``nn.Module`` holding the reference's parameter tree under
the same names: ``w_ih`` ``(input, gates * hidden)`` and ``w_hh`` ``(hidden,
gates * hidden)`` packed over the gates, ``b`` (and mLSTM's ``w_mx``,
``w_mh``), so ``params_from_numpy`` loads the JAX ``init`` tree as it is.
``cell(state, x_t)`` is one step, as the reference's ``cell(p, state,
x_t)``. :class:`RNN` runs each layer over time in a Python loop (the
reference's ``lax.scan``) and applies the inter-layer dropout from an
explicit ``torch.Generator``. The reference's quirks stay: the LSTM gate
order is (i, f, g, o), and the GRU adds its bias to the input projection
only (``rnn.py:101-111``). Plain PyTorch on either device: the reference
has no Pallas kernel here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch._params import load_tree_
from apex_tpu_torch.utils.nn import inverted_dropout


class _Cell(nn.Module):
    """The packed-GEMM plumbing the cells share (``rnn.py:29-63``): the
    gates of one step are ``x @ w_ih + h @ w_hh + b``, ``n_gates`` blocks of
    ``hidden``. The init draws ``w_ih`` and ``w_hh`` uniform in ``+-1 /
    sqrt(hidden)`` from ``seed`` and zeros ``b``."""

    n_gates = 1

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.bias = bias
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(int(seed))
        width = self.n_gates * hidden_size
        self.w_ih = self._uniform(input_size, width, dev, dtype)
        self.w_hh = self._uniform(hidden_size, width, dev, dtype)
        self.b = nn.Parameter(torch.zeros(width, dtype=dtype, device=dev)) \
            if bias else None

    def _uniform(self, rows: int, cols: int, dev, dtype) -> nn.Parameter:
        bound = 1.0 / math.sqrt(self.hidden_size)
        w = torch.empty(rows, cols, dtype=dtype, device=dev)
        return nn.Parameter(w.uniform_(-bound, bound, generator=self._gen))

    def params_from_numpy(self, tree: Dict[str, Any]) -> "_Cell":
        """Load the JAX cell's ``init`` tree (numpy arrays or tensors)."""
        return load_tree_(self, tree)

    def initial_state(self, batch: int, like: torch.Tensor):
        return torch.zeros(batch, self.hidden_size, dtype=like.dtype,
                           device=like.device)

    def _gates(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        z = x @ self.w_ih + h @ self.w_hh
        return z + self.b if self.bias else z


class RNNReLUCell(_Cell):
    """``h' = relu(x W + h U + b)``."""

    def forward(self, h, x):
        return torch.relu(self._gates(x, h))


class RNNTanhCell(_Cell):
    """``h' = tanh(x W + h U + b)``."""

    def forward(self, h, x):
        return torch.tanh(self._gates(x, h))


def _lstm_update(z: torch.Tensor, c: torch.Tensor):
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class LSTMCell(_Cell):
    """The standard LSTM, gates in the order (i, f, g, o); state ``(h,
    c)``."""

    n_gates = 4

    def initial_state(self, batch, like):
        z = super().initial_state(batch, like)
        return (z, z)

    def forward(self, state, x):
        h, c = state
        return _lstm_update(self._gates(x, h), c)


class GRUCell(_Cell):
    """GRU with gates (r, z, n): the reset gate scales the hidden
    projection of the candidate, so the input and hidden projections stay
    apart, and the bias joins the input projection only."""

    n_gates = 3

    def forward(self, h, x):
        zi = x @ self.w_ih
        zh = h @ self.w_hh
        if self.bias:
            zi = zi + self.b
        ri, zi_g, ni = torch.chunk(zi, 3, dim=-1)
        rh, zh_g, nh = torch.chunk(zh, 3, dim=-1)
        r = torch.sigmoid(ri + rh)
        z = torch.sigmoid(zi_g + zh_g)
        n = torch.tanh(ni + r * nh)
        return (1.0 - z) * n + z * h


class mLSTMCell(LSTMCell):
    """Multiplicative LSTM (``rnn.py:114-134``): the gates see ``m = (x
    W_mx) * (h W_mh)`` where the LSTM sees ``h``. ``w_mx`` and ``w_mh``
    follow ``w_ih`` and ``w_hh`` in the init."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__(input_size, hidden_size, bias, device, dtype, seed)
        dev = self.w_ih.device
        self.w_mx = self._uniform(input_size, hidden_size, dev, dtype)
        self.w_mh = self._uniform(hidden_size, hidden_size, dev, dtype)

    def forward(self, state, x):
        h, c = state
        m = (x @ self.w_mx) * (h @ self.w_mh)
        return _lstm_update(self._gates(x, m), c)


def _cell_output(state):
    return state[0] if isinstance(state, tuple) else state


class RNN(nn.Module):
    """The stacked runner (``rnn.py:141-185``): ``forward(x,
    initial_states=None, dropout_generator=None)`` with ``x`` ``(batch,
    time, input)`` returns ``(output, finals)``: the last layer's outputs
    ``(batch, time, hidden)`` and each layer's final state. Between layers
    the outputs take inverted dropout at ``dropout`` when a generator is
    given."""

    def __init__(self, cells: Sequence[_Cell], dropout: float = 0.0):
        super().__init__()
        self.cells = nn.ModuleList(cells)
        self.dropout = dropout

    def params_from_numpy(self, trees: Sequence[Dict[str, Any]]) -> "RNN":
        """Load the JAX ``RNN.init`` list, one tree a cell."""
        if len(trees) != len(self.cells):
            raise ValueError(f"{len(trees)} trees for {len(self.cells)} "
                             f"cells")
        for cell, tree in zip(self.cells, trees):
            cell.params_from_numpy(tree)
        return self

    def forward(self, x: torch.Tensor,
                initial_states: Optional[List[Any]] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[Any]]:
        batch = x.shape[0]
        states = initial_states or [c.initial_state(batch, x)
                                    for c in self.cells]
        finals = []
        h_seq = x
        for li, cell in enumerate(self.cells):
            state = states[li]
            outs = []
            for t in range(h_seq.shape[1]):
                state = cell(state, h_seq[:, t])
                outs.append(_cell_output(state))
            h_seq = torch.stack(outs, dim=1)
            finals.append(state)
            if li < len(self.cells) - 1:
                h_seq = inverted_dropout(h_seq, self.dropout,
                                         dropout_generator)
        return h_seq, finals


def _stack(cls, input_size, hidden_size, num_layers, bias, dropout, device,
           seed) -> RNN:
    return RNN([cls(input_size if i == 0 else hidden_size, hidden_size, bias,
                    device=device, seed=seed + i)
                for i in range(num_layers)], dropout)


def make_lstm(input_size: int, hidden_size: int, num_layers: int = 1,
              bias: bool = True, dropout: float = 0.0,
              device: DeviceLike = None, seed: int = 0) -> RNN:
    """A stack of ``num_layers`` LSTM cells (``rnn.py:188-194``)."""
    return _stack(LSTMCell, input_size, hidden_size, num_layers, bias,
                  dropout, device, seed)


def make_gru(input_size: int, hidden_size: int, num_layers: int = 1,
             bias: bool = True, dropout: float = 0.0,
             device: DeviceLike = None, seed: int = 0) -> RNN:
    """A stack of ``num_layers`` GRU cells (``rnn.py:197-202``)."""
    return _stack(GRUCell, input_size, hidden_size, num_layers, bias,
                  dropout, device, seed)
