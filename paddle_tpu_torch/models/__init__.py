"""Models of the port: GPT (training and serving), the SSM family
(serving and inference), BERT / ERNIE (training), the Transformer
seq2seq (training and greedy decoding) and the carry-over of paddle_tpu
weights and optimizer state."""
from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel,
                   ErnieForSequenceClassification, ErnieModel, bert_base,
                   ernie_base)
from .convert import load_paddle_tpu_opt_state, load_paddle_tpu_state
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_1p3b, gpt_6p7b,
                  gpt_medium, gpt_small, gpt_tiny)
from .seq2seq import Seq2SeqConfig, Seq2SeqTransformer
from .ssm import (SSMConfig, SSMForCausalLM, SSMModel, ssm_hybrid_tiny,
                  ssm_tiny)

__all__ = ["BertConfig", "BertForMaskedLM", "BertForSequenceClassification",
           "BertModel", "ErnieForSequenceClassification", "ErnieModel",
           "bert_base", "ernie_base", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "Seq2SeqConfig", "Seq2SeqTransformer", "SSMConfig",
           "SSMForCausalLM", "SSMModel", "gpt_1p3b", "gpt_6p7b",
           "gpt_medium", "gpt_small", "gpt_tiny", "load_paddle_tpu_state",
           "load_paddle_tpu_opt_state", "ssm_hybrid_tiny", "ssm_tiny"]
