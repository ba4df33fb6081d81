"""Recurrent layers. Counterpart: paddle_tpu/nn/layer/rnn.py, class for
class, with its parameter names, shapes and defaults.

The reference runs the recurrence as one `lax.scan` over raw arrays
(`_cell_scan`). Here the loop over time is Python over torch ops: the
input projection `x @ W_ih^T + b_ih` of the whole sequence is one
product, then each step runs one recurrent product and the gate math.
A train step captures the loop into its CUDA graph like any other ops.
cuDNN's RNN (`torch._VF.lstm`, `torch.nn.LSTM`) is not called: plain
ops keep the reference's arithmetic and capture simply (ROADMAP.md
lists it as a later candidate).

- Gate orders are the reference's: LSTM i, f, g, o; GRU r, z, n with
  `b_hh` inside `r * (h @ W_hh^T + b_hh)`.
- Weights and biases start from Uniform(-1/sqrt(H), 1/sqrt(H)).
- `SimpleRNN` / `LSTM` / `GRU` stack `num_layers` layers of `RNN`s
  (two a layer when bidirectional: the outputs concatenated), with
  dropout between layers in training; finals are [layers * dirs, B, H]
  and initial states are sliced the reference's way (layer * dirs +
  direction). `time_major` takes and gives [T, B, ...].
- `sequence_length` is accepted and ignored, as on the reference
  (ROADMAP.md, queue C): padded steps run through the recurrence.

Port layers (`_paddle_io = False`): a call with Paddle Tensors unwraps
them and wraps what it returns. `RNN` runs a cell of another class (a
user's `RNNCellBase`) by calling it once a step.
"""
import math

import torch

from ...framework.core import _is_wrapper, unwrap, wrap_tree
from ...framework.dtype import convert_dtype
from .. import initializer as I
from ..functional import common as FC
from .container import LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    """The base of cells: a user's subclass gets Paddle Tensors in
    `forward`, as any user Layer."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """Full states of `shape` (default: the cell's `state_shape`) for
        `batch_ref`'s batch, float32 unless `dtype` says otherwise, on
        its device; Tensors when `batch_ref` is one."""
        ref = unwrap(batch_ref)
        B = ref.shape[batch_dim_idx]
        dt = convert_dtype(dtype) if dtype else torch.float32
        state_shape = shape or self.state_shape

        def full(s):
            return torch.full([B] + list(s), init_value, dtype=dt,
                              device=ref.device)
        if isinstance(state_shape, tuple):
            out = tuple(full(s) for s in state_shape)
        else:
            out = full(state_shape)
        return wrap_tree(out) if _is_wrapper(batch_ref) else out


def _uniform_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


class _Cell(RNNCellBase):
    """The three cells' parameters: W_ih [gates * H, I], W_hh
    [gates * H, H], b_ih and b_hh [gates * H]."""
    _paddle_io = False
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        init = _uniform_init(hidden_size)
        G = self.GATES * hidden_size
        self.weight_ih = self.create_parameter(
            [G, input_size], weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [G, hidden_size], weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [G], bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [G], bias_hh_attr, is_bias=True, default_initializer=init)

    def project(self, x):
        """x @ W_ih^T + b_ih, over any leading dims (a whole sequence at
        once)."""
        return torch.matmul(x, self.weight_ih.t()) + self.bias_ih

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        return self.step(self.project(inputs), states)


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    @property
    def state_shape(self):
        return [self.hidden_size]

    def step(self, xw, h):
        """(output, new state) from the projected input `xw`."""
        pre = xw + torch.matmul(h, self.weight_hh.t()) + self.bias_hh
        h = torch.tanh(pre) if self.activation == "tanh" else \
            torch.relu(pre)
        return h, h


class LSTMCell(_Cell):
    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ([self.hidden_size], [self.hidden_size])

    def step(self, xw, states):
        h, c = states
        gates = xw + torch.matmul(h, self.weight_hh.t()) + self.bias_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class GRUCell(_Cell):
    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return [self.hidden_size]

    def step(self, xw, h):
        gh = torch.matmul(h, self.weight_hh.t()) + self.bias_hh
        i_r, i_z, i_n = xw.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1 - z) * n + z * h
        return h, h


def _run(cell, xs, states, reverse):
    """The cell over time-major xs [T, B, I] from `states`: (outputs
    [T, B, H], final states)."""
    T = xs.shape[0]
    order = range(T - 1, -1, -1) if reverse else range(T)
    outs = [None] * T
    if isinstance(cell, _Cell):
        xw = cell.project(xs)
        for t in order:
            outs[t], states = cell.step(xw[t], states)
    else:
        for t in order:
            outs[t], states = cell(xs[t], states)
    return torch.stack(outs), states


class RNN(Layer):
    """A cell over a whole sequence: (outputs, final states)."""
    _paddle_io = False

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                xs, dtype=xs.dtype, batch_dim_idx=1)
        elif isinstance(initial_states, list):
            initial_states = tuple(initial_states)
        ys, final = _run(self.cell, xs, initial_states, self.is_reverse)
        return (ys if self.time_major else ys.transpose(0, 1)), final


class BiRNN(Layer):
    """A forward and a reverse `RNN` over the same inputs, outputs
    concatenated on the last axis: (outputs, (fw finals, bw finals))."""
    _paddle_io = False

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw = st_bw = None
        if initial_states is not None:
            st_fw, st_bw = initial_states
        out_fw, s_fw = self.rnn_fw(inputs, st_fw)
        out_bw, s_bw = self.rnn_bw(inputs, st_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (s_fw, s_bw)


class _RNNBase(Layer):
    _paddle_io = False
    CELL = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        num_dir = 2 if self.bidirect else 1
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)

        def make_cell(in_size):
            if self.CELL is SimpleRNNCell:
                return SimpleRNNCell(in_size, hidden_size,
                                     activation or "tanh", *attrs)
            return self.CELL(in_size, hidden_size, *attrs)

        self.layers_fw = LayerList()
        self.layers_bw = LayerList() if self.bidirect else None
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * num_dir
            self.layers_fw.append(make_cell(in_size))
            if self.bidirect:
                self.layers_bw.append(make_cell(in_size))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        is_lstm = self.CELL is LSTMCell
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        dirs = [(self.layers_fw, False)] + (
            [(self.layers_bw, True)] if self.bidirect else [])
        finals_h, finals_c = [], []
        for layer in range(self.num_layers):
            outs = []
            for d, (cells, reverse) in enumerate(dirs):
                cell = cells[layer]
                states = cell.get_initial_states(
                    xs, dtype=xs.dtype, batch_dim_idx=1) \
                    if initial_states is None else self._slice_states(
                        initial_states, layer, d, is_lstm)
                ys, final = _run(cell, xs, states, reverse)
                outs.append(ys)
                finals_h.append(final[0] if is_lstm else final)
                if is_lstm:
                    finals_c.append(final[1])
            xs = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
            if self.dropout and layer < self.num_layers - 1:
                xs = FC.dropout(xs, self.dropout, training=self.training)
        out = xs if self.time_major else xs.transpose(0, 1)
        h = torch.stack(finals_h)
        if is_lstm:
            return out, (h, torch.stack(finals_c))
        return out, h

    def _slice_states(self, initial_states, layer, direction, is_lstm):
        idx = layer * (2 if self.bidirect else 1) + direction
        if is_lstm:
            h, c = initial_states
            return h[idx], c[idx]
        return initial_states[idx]


class SimpleRNN(_RNNBase):
    CELL = SimpleRNNCell


class LSTM(_RNNBase):
    CELL = LSTMCell


class GRU(_RNNBase):
    CELL = GRUCell
