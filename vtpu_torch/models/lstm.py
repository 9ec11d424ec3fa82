"""The LSTM classifier of the ai-benchmark LSTM rows (hidden 1024, seq
300): ``vtpu/models/lstm.py`` in PyTorch -- embed, an LSTM over the
sequence from a zero carry, the last hidden state, a dense layer.

The recurrence is ``nn.LSTM`` (cuDNN on the card), as the JAX package
leaves its scan to XLA.  flax's ``OptimizedLSTMCell`` keeps four input
kernels ``i{i,f,g,o}`` without bias and four hidden kernels
``h{i,f,g,o}`` with one; torch's gate order is the same (i, f, g, o),
``weight_ih_l0`` / ``weight_hh_l0`` are the concatenated kernels
transposed, ``bias_ih_l0`` is the hidden kernels' bias and
``bias_hh_l0`` is 0 (``vtpu_torch.models.convert``).  Parameters stay
f32; under a bf16 ``dtype`` the LSTM runs on a bf16 copy of them, cast
as one flat buffer in cuDNN's order (w_ih, w_hh, b_ih, b_hh), which
cuDNN reads in place (four separate tensors it would repack into one on
every call).  Without autograd the copy is kept until a parameter
changes.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vtpu_torch.device import resolve_device
from vtpu_torch.models.layers import Dense, lecun_normal_


class LSTMClassifier(nn.Module):
    """``forward(tokens [b, s])`` returns ``(logits, {})``.  flax's
    ``nn.Embed`` returns NaN for an id outside the vocabulary, where
    ``nn.Embedding`` raises: keep ids in range."""

    def __init__(self, hidden: int = 1024, num_classes: int = 2,
                 vocab: int = 30000, embed: int = 512, dtype=torch.bfloat16,
                 *, device="cuda", generator=None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.Embed_0 = nn.Embedding(vocab, embed, device="meta")
        self.OptimizedLSTMCell_0 = nn.LSTM(embed, hidden, batch_first=True,
                                           device="meta")
        self.Dense_0 = Dense(hidden, num_classes, dtype=torch.float32,
                             device="meta")
        self.to_empty(device=dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator) -> None:
        d = self.Embed_0.weight.shape[1]
        self.Embed_0.weight.normal_(0.0, math.sqrt(1.0 / d),
                                    generator=generator)
        cell = self.OptimizedLSTMCell_0
        lecun_normal_(cell.weight_ih_l0, cell.input_size, generator)
        lecun_normal_(cell.weight_hh_l0, cell.hidden_size, generator)
        cell.bias_ih_l0.zero_()
        cell.bias_hh_l0.zero_()
        self.Dense_0.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor):
        x = self.Embed_0(tokens.long()).to(self.dtype)
        h0 = x.new_zeros(1, x.shape[0], self.OptimizedLSTMCell_0.hidden_size)
        y, _, _ = torch.lstm(x, (h0, h0), self._weights(), True, 1, 0.0,
                             self.training, False, True)
        return self.Dense_0(y[:, -1]).float(), {}

    def _weights(self) -> list:
        """The LSTM's weights in the compute dtype: views of one buffer,
        kept (when no gradient is wanted) until a parameter's address or
        version changes (an optimizer step, a load)."""
        cell = self.OptimizedLSTMCell_0
        params = [cell.weight_ih_l0, cell.weight_hh_l0, cell.bias_ih_l0,
                  cell.bias_hh_l0]
        keep = not (torch.is_grad_enabled()
                    and any(p.requires_grad for p in params))
        key = (self.dtype, *((p.data_ptr(), p._version) for p in params))
        cached = self.__dict__.get("_cast")
        if keep and cached is not None and cached[0] == key:
            return cached[1]
        flat = torch.cat([p.reshape(-1) for p in params]).to(self.dtype)
        views = [t.view_as(p) for t, p in
                 zip(flat.split([p.numel() for p in params]), params)]
        self.__dict__["_cast"] = (key, views) if keep else None
        return views
