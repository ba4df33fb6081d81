"""Transformer encoder-decoder seq2seq (the machine-translation family).
Counterpart: paddle_tpu/models/seq2seq.py, with its parameter names.

- Embeddings: the token table's rows times sqrt(d_model), plus a learned
  position table, then dropout; source and target have their own token
  tables and share the position table.
- `nn.Transformer` (post-norm, ReLU) with the additive pad mask
  [B, 1, 1, T_src] (-1e9 at the source's pad ids) as the encoder's
  self-attention mask and the decoder's memory mask, and the causal
  mask (-inf above the diagonal) on the decoder's self-attention. Every
  attention has a mask, so each takes the plain composition, as the
  reference's does, and never the flash kernels.
- The generator is tied to the target table: logits = out @
  tgt_embed.weight^T, one parameter in two uses (its grads summed).
- `loss` is the mean cross-entropy over the non-pad labels
  (`ignore_index=pad_id`); `greedy_decode` runs one forward a token,
  keeps the tokens on the device and reads back only the loop's exit
  test (every row has emitted `eos_id`).
"""
import math

import torch

from ..amp import cast_inputs
from ..framework.core import paddle_io
from .. import nn
from ..nn.functional import loss as FL
from ..nn.layer.transformer import _add

__all__ = ["Seq2SeqConfig", "Seq2SeqTransformer"]


class Seq2SeqConfig:
    """The reference's Seq2SeqConfig, field for field: Transformer-base
    (Vaswani et al., 2017) by default."""

    def __init__(self, src_vocab_size=32000, tgt_vocab_size=32000,
                 d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 max_position_embeddings=512, pad_id=0, bos_id=1,
                 eos_id=2):
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.d_model = d_model
        self.nhead = nhead
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.dim_feedforward = dim_feedforward
        self.dropout = dropout
        self.max_position_embeddings = max_position_embeddings
        self.pad_id = pad_id
        self.bos_id = bos_id
        self.eos_id = eos_id


class Seq2SeqTransformer(nn.Layer):
    _paddle_io = False

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.src_embed = nn.Embedding(cfg.src_vocab_size, cfg.d_model)
        self.tgt_embed = nn.Embedding(cfg.tgt_vocab_size, cfg.d_model)
        self.pos_embed = nn.Embedding(cfg.max_position_embeddings,
                                      cfg.d_model)
        self.transformer = nn.Transformer(
            d_model=cfg.d_model, nhead=cfg.nhead,
            num_encoder_layers=cfg.num_encoder_layers,
            num_decoder_layers=cfg.num_decoder_layers,
            dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout)
        self.drop = nn.Dropout(cfg.dropout)
        self.scale = float(math.sqrt(cfg.d_model))

    def _embed(self, table, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        return self.drop(_add(table(ids) * self.scale, self.pos_embed(pos)))

    def _pad_mask(self, ids):
        """Additive [B, 1, 1, T] float32: -1e9 at pad ids, else 0."""
        pad = (ids == self.cfg.pad_id)[:, None, None, :]
        return torch.where(pad, -1e9, 0.0).float()

    def forward(self, src_ids, tgt_ids):
        """Teacher-forced logits [B, T_tgt, tgt_vocab]."""
        src = self._embed(self.src_embed, src_ids)
        tgt = self._embed(self.tgt_embed, tgt_ids)
        T = tgt_ids.shape[1]
        causal = torch.full((T, T), float("-inf"),
                            device=tgt_ids.device).triu(1)
        pad = self._pad_mask(src_ids)
        out = self.transformer(src, tgt, src_mask=pad, tgt_mask=causal,
                               memory_mask=pad)
        out, w = cast_inputs("matmul", out, self.tgt_embed.weight)
        return torch.matmul(out, w.t())

    @paddle_io
    def loss(self, src_ids, tgt_ids, label_ids):
        logits = self(src_ids, tgt_ids)
        return FL.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                label_ids.reshape(-1),
                                ignore_index=self.cfg.pad_id)

    @paddle_io
    @torch.no_grad()
    def greedy_decode(self, src_ids, max_len=32):
        """[B, 1 + steps] int64: bos, then each step's argmax; a row
        that has emitted eos continues with pad. Stops after `max_len`
        steps or when every row has emitted eos."""
        B = src_ids.shape[0]
        out = torch.full((B, 1), self.cfg.bos_id, dtype=torch.int64,
                         device=src_ids.device)
        finished = torch.zeros(B, dtype=torch.bool, device=src_ids.device)
        for _ in range(max_len):
            nxt = self(src_ids, out)[:, -1, :].argmax(-1)
            nxt = torch.where(finished, self.cfg.pad_id, nxt)
            finished |= nxt == self.cfg.eos_id
            out = torch.cat([out, nxt[:, None]], dim=1)
            if bool(finished.all()):
                break
        return out
