"""Models of the port: GPT (serving path) and the weight carry-over from
paddle_tpu state dicts."""
from .convert import load_paddle_tpu_state
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_medium, gpt_tiny

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "gpt_medium",
           "gpt_tiny", "load_paddle_tpu_state"]
