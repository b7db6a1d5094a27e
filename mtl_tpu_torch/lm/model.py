"""Word-level recurrent LM (port of mtl_tpu/lm/model.py; reference
lm/model/rnn_model.py:12-70).

Embedding -> nlayers x LSTM/GRU/RNN_TANH/RNN_RELU (dropout on the
embedding, between layers and on the top output) -> linear, optionally tied
to the embedding (``logits = h @ embed.T + decoder_bias``). Layout is the
reference's column-major [T, B].

Each layer keeps the flax cells' single bias per gate (PARITY.md:143-147):
LSTM biases sit on the hidden side (``h*``), GRU biases on ``ir``, ``iz``,
``in`` and ``hn``, the simple cells' on the input side. The recurrence runs
as one library call per layer (``torch.lstm`` / ``gru`` / ``rnn_tanh`` /
``rnn_relu``: cuDNN on the card), whose cells carry two biases; the other
one is a zero buffer, not a parameter, so training sees one bias per gate
as flax does. The library call runs in the module's training mode: cuDNN
computes a backward only from a forward in training mode. The forward runs
in true f32 (``strict_f32``): LM scores enter the beam's ranking.

``RNNLM(cell_loop=True)`` (the LM's ``--second-order`` meta-transfer) runs
the recurrence instead as an explicit loop over time of matmuls and gate
nonlinearities, which autograd differentiates twice: cuDNN's RNN backward
has no double backward. Both routes compute the same cells.
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..models.layers import dropout
from ..utils.precision import strict_f32

GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}
_RECURRENCE = {"LSTM": torch.lstm, "GRU": torch.gru,
               "RNN_TANH": torch.rnn_tanh, "RNN_RELU": torch.rnn_relu}


class RNNLayer(nn.Module):
    """One recurrent layer. ``weight_ih`` [G*H, in] and ``weight_hh``
    [G*H, H] stack the gates in torch's order (LSTM i, f, g, o; GRU r, z,
    n); ``bias`` is the flax cell's one bias per gate: LSTM [4H] (hidden
    side), GRU [4H] (``ir``, ``iz``, ``in`` | ``hn``), simple cells [H]
    (input side)."""

    def __init__(self, rnn_type: str, in_features: int, hidden: int):
        super().__init__()
        if rnn_type not in GATES:
            raise ValueError(
                "An invalid option for `--model` was supplied, options are "
                "['LSTM', 'GRU', 'RNN_TANH' or 'RNN_RELU']")
        self.rnn_type, self.hidden = rnn_type, hidden
        g = GATES[rnn_type]
        self.weight_ih = nn.Parameter(torch.zeros(g * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.zeros(g * hidden, hidden))
        n_bias = hidden if g == 1 else 4 * hidden
        self.bias = nn.Parameter(torch.zeros(n_bias))
        n_zero = {"LSTM": 4 * hidden, "GRU": 2 * hidden}.get(rnn_type, hidden)
        self.register_buffer("zero_bias", torch.zeros(n_zero),
                             persistent=False)

    def biases(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(input-side, hidden-side) biases in the library's layout."""
        if self.rnn_type == "LSTM":
            return self.zero_bias, self.bias
        if self.rnn_type == "GRU":
            h3 = 3 * self.hidden
            return self.bias[:h3], torch.cat([self.zero_bias, self.bias[h3:]])
        return self.bias, self.zero_bias

    def forward(self, x: torch.Tensor, carry, cell_loop: bool = False):
        """x [T, B, in]; carry (h, c) for LSTM, else h, each [1, B, H].
        Returns (output [T, B, H], new carry): one library call, or with
        ``cell_loop`` the explicit loop over time."""
        if cell_loop:
            return self._cell_loop(x, carry)
        params = [self.weight_ih, self.weight_hh, *self.biases()]
        hx = list(carry) if self.rnn_type == "LSTM" else carry
        with warnings.catch_warnings():
            # the library's two biases are assembled per call, so cuDNN
            # packs the layer's weights every call (one copy, ~1 MB at the
            # default 200 x 200) and would warn about it once
            warnings.filterwarnings("ignore", message="RNN module weights")
            out = _RECURRENCE[self.rnn_type](x, hx, params, True, 1, 0.0,
                                             self.training, False, False)
        if self.rnn_type == "LSTM":
            return out[0], (out[1], out[2])
        return out[0], out[1]

    def _cell_loop(self, x: torch.Tensor, carry):
        """The library's cells (torch's gate equations) one step at a time,
        in differentiable tensor ops."""
        b_ih, b_hh = self.biases()
        xs = F.linear(x, self.weight_ih, b_ih)  # every step's input side
        lstm = self.rnn_type == "LSTM"
        h, c = (carry[0][0], carry[1][0]) if lstm else (carry[0], None)
        outs = []
        for xt in xs:
            hs = F.linear(h, self.weight_hh, b_hh)
            if lstm:
                i, f, g, o = (xt + hs).chunk(4, -1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            elif self.rnn_type == "GRU":
                xr, xz, xn = xt.chunk(3, -1)
                hr, hz, hn = hs.chunk(3, -1)
                r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
                h = (1 - z) * torch.tanh(xn + r * hn) + z * h
            else:
                pre = xt + hs
                h = torch.tanh(pre) if self.rnn_type == "RNN_TANH" \
                    else torch.relu(pre)
            outs.append(h)
        out = torch.stack(outs)
        return out, ((h[None], c[None]) if lstm else h[None])


class RNNLM(nn.Module):
    def __init__(self, rnn_type: str, ntoken: int, ninp: int, nhid: int,
                 nlayers: int, dropout: float = 0.5,
                 tie_weights: bool = False, cell_loop: bool = False):
        super().__init__()
        if tie_weights and nhid != ninp:
            raise ValueError(
                "When using the tied flag, nhid must be equal to emsize")
        self.rnn_type, self.ntoken, self.nhid = rnn_type, ntoken, nhid
        self.dropout, self.tie_weights = dropout, tie_weights
        self.cell_loop = cell_loop
        self.embed = nn.Embedding(ntoken, ninp)
        self.rnns = nn.ModuleList(
            RNNLayer(rnn_type, ninp if i == 0 else nhid, nhid)
            for i in range(nlayers))
        if tie_weights:
            self.decoder_bias = nn.Parameter(torch.zeros(ntoken))
        else:
            self.decoder = nn.Linear(nhid, ntoken)

    def init_carry(self, batch_size: int, device=None) -> List:
        device = device or self.embed.weight.device
        z = lambda: torch.zeros(1, batch_size, self.nhid, device=device)
        if self.rnn_type == "LSTM":
            return [(z(), z()) for _ in self.rnns]
        return [z() for _ in self.rnns]

    def forward(self, tokens: torch.Tensor, carry: Optional[List] = None,
                gen: Optional[torch.Generator] = None):
        """tokens [T, B] ids -> (logits [T, B, V] f32, new carry). Dropout
        draws from ``gen`` and is the identity without one."""
        if carry is None:
            carry = self.init_carry(tokens.shape[1], tokens.device)
        with strict_f32():
            h = dropout(self.embed(tokens), self.dropout, gen)
            new_carry = []
            for i, rnn in enumerate(self.rnns):
                h, c = rnn(h, carry[i], self.cell_loop)
                new_carry.append(c)
                if i < len(self.rnns) - 1:
                    h = dropout(h, self.dropout, gen)
            h = dropout(h, self.dropout, gen)
            if self.tie_weights:
                logits = h @ self.embed.weight.T + self.decoder_bias
            else:
                logits = self.decoder(h)
        return logits, new_carry


@torch.no_grad()
def init_lm_weights(model: RNNLM, generator: torch.Generator) -> None:
    """Seeded init drawn on the CPU: embedding and output weights
    uniform(-0.1, 0.1), output bias zero (the reference's init_weights,
    rnn_model.py:49-53); recurrent weights uniform(-1/sqrt(H), 1/sqrt(H))
    (torch's RNN init), gate biases zero. Init cannot match flax's draws;
    parity runs load one weight set into both packages."""
    def uniform(p, bound):
        w = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
        p.copy_(w)

    uniform(model.embed.weight, 0.1)
    if not model.tie_weights:
        uniform(model.decoder.weight, 0.1)
        model.decoder.bias.zero_()
    else:
        model.decoder_bias.zero_()
    for rnn in model.rnns:
        uniform(rnn.weight_ih, 1.0 / math.sqrt(model.nhid))
        uniform(rnn.weight_hh, 1.0 / math.sqrt(model.nhid))
        rnn.bias.zero_()
