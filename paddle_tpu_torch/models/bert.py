"""BERT / ERNIE: the trunk, the masked-LM head and the sequence
classifier.

Counterpart: paddle_tpu/models/bert.py, class for class, with its
parameter names and shapes, so models/convert.py carries a paddle_tpu
state dict across name for name (`decoder_bias` and ERNIE's
`task_type_embeddings`, which a forward without task-type ids leaves
unused, included).

- `BertModel`: word + position + token-type (+ task-type) embeddings,
  LayerNorm, dropout, then `nn.TransformerEncoder` of post-norm
  `TransformerEncoderLayer`s (erf GELU). Without `attention_mask` the
  attention runs the flash kernels #2-#4 (non-causal); a [B, T] 1/0
  mask becomes the additive [B, 1, 1, T] mask (1 - m) * -1e4, which
  takes the plain composition. The pooler is tanh(Linear(seq[:, 0])).
- `BertForMaskedLM`: transform (Linear, erf GELU, LayerNorm), then
  logits = h @ word_embeddings^T + decoder_bias (the tied head); `loss`
  is their mean cross-entropy against labels (-100 ignored).
- `BertForSequenceClassification`: dropout and a Linear on the pooled
  output.

The sums and the tied product apply the amp policy of the reference's
ops ("add", "subtract", "multiply", "matmul": `amp.cast_inputs`), so
under `auto_cast(level="O1")` the logits come out float32 (a bfloat16
product plus the float32 bias) and under O2 in the low dtype, as on the
reference; the loss is float32 either way.

Built on the current device (`paddle.set_device`), in float32, its
weights drawn by the reference's initializers from the global generator
(`paddle.seed`): Normal(0, initializer_range) embeddings, XavierNormal
Linears, zero biases, unit LayerNorms. `ErnieModel` /
`ErnieForSequenceClassification` are the same classes; `ernie_base`
turns the task-type embeddings on.
"""
import torch

from ..amp import cast_inputs
from ..framework.core import paddle_io
from ..framework.dtype import weak_scalar
from .. import nn
from ..nn.functional import activation as FA
from ..nn.functional import loss as FL
from ..nn.layer.transformer import _add

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "ErnieModel",
           "ErnieForSequenceClassification", "bert_base", "ernie_base"]


class BertConfig:
    """The reference's BertConfig, field for field."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 task_type_vocab_size=0, hidden_dropout=0.1,
                 attention_dropout=0.1, layer_norm_eps=1e-12,
                 initializer_range=0.02, pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.task_type_vocab_size = task_type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.layer_norm_eps = layer_norm_eps
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id


class BertEmbeddings(nn.Layer):
    _paddle_io = False

    def __init__(self, cfg):
        super().__init__()
        init = nn.initializer.Normal(0.0, cfg.initializer_range)
        self.word_embeddings = nn.Embedding(cfg.vocab_size,
                                            cfg.hidden_size,
                                            weight_attr=init)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, weight_attr=init)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, weight_attr=init)
        self.task_type_embeddings = None
        if cfg.task_type_vocab_size:  # ERNIE 3.0's task embedding
            self.task_type_embeddings = nn.Embedding(
                cfg.task_type_vocab_size, cfg.hidden_size, weight_attr=init)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        B, T = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros(B, T, dtype=torch.long,
                                         device=input_ids.device)
        emb = _add(_add(self.word_embeddings(input_ids),
                        self.position_embeddings(position_ids)),
                   self.token_type_embeddings(token_type_ids))
        if self.task_type_embeddings is not None \
                and task_type_ids is not None:
            emb = _add(emb, self.task_type_embeddings(task_type_ids))
        return self.dropout(self.layer_norm(emb))


def _additive_mask(attention_mask):
    """[B, T] 1/0 -> (1 - m) * -1e4 as [B, 1, 1, T], float32 unless the
    amp policy casts the subtraction and product (O2)."""
    (m,) = cast_inputs("subtract", attention_mask.float())
    (m,) = cast_inputs("multiply", 1.0 - m)
    return (m * weak_scalar(-1e4, m))[:, None, None, :]


class BertModel(nn.Layer):
    _paddle_io = False

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout, activation="gelu",
            attn_dropout=cfg.attention_dropout, normalize_before=False)
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        """(sequence output [B, T, hidden], pooled output [B, hidden])."""
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        mask = None if attention_mask is None else \
            _additive_mask(attention_mask)
        seq = self.encoder(x, mask)
        return seq, torch.tanh(self.pooler(seq[:, 0]))


class BertForMaskedLM(nn.Layer):
    _paddle_io = False

    def __init__(self, cfg):
        super().__init__()
        self.bert = BertModel(cfg)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.decoder_bias = self.create_parameter(
            [cfg.vocab_size], is_bias=True)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """Logits [B, T, vocab]."""
        seq, _ = self.bert(input_ids, token_type_ids,
                           attention_mask=attention_mask)
        h = self.layer_norm(FA.gelu(self.transform(seq)))
        h, w = cast_inputs("matmul", h,
                           self.bert.embeddings.word_embeddings.weight)
        if h.dtype != w.dtype:
            dt = torch.promote_types(h.dtype, w.dtype)
            h, w = h.to(dt), w.to(dt)
        return _add(h @ w.T, self.decoder_bias)

    @paddle_io
    def loss(self, input_ids, labels, token_type_ids=None,
             attention_mask=None, ignore_index=-100):
        """Mean cross-entropy of the logits against labels [B, T]
        (`ignore_index` rows count nothing), float32; a Tensor when
        called with Tensors."""
        logits = self(input_ids, token_type_ids, attention_mask)
        V = logits.shape[-1]
        return FL.cross_entropy(logits.reshape(-1, V), labels.reshape(-1),
                                ignore_index=ignore_index)


class BertForSequenceClassification(nn.Layer):
    _paddle_io = False

    def __init__(self, cfg, num_classes=2, dropout=None):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(dropout if dropout is not None
                                  else cfg.hidden_dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask,
                              task_type_ids=task_type_ids)
        return self.classifier(self.dropout(pooled))


# ERNIE is the same trunk with the task-type embeddings on
ErnieModel = BertModel
ErnieForSequenceClassification = BertForSequenceClassification


def bert_base(vocab_size=30522):
    return BertConfig(vocab_size=vocab_size)


def ernie_base(vocab_size=40000):
    return BertConfig(vocab_size=vocab_size, task_type_vocab_size=3)
