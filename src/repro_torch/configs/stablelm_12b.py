"""stablelm-12b [hf:stabilityai]: 40L d5120 32H GQA(kv=8) d_ff 13824,
vocab 100352, dense SwiGLU. head_dim = 5120/32 = 160."""
from repro_torch.configs.lm_common import make_lm_bundle
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="stablelm-12b", n_layers=40, d_model=5120, n_heads=32, n_kv=8,
    head_dim=160, d_ff=13824, vocab=100352,
    q_chunk=512, logits_bf16=True)

SMOKE = LMConfig(
    name="stablelm12b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    head_dim=16, d_ff=128, vocab=503, compute_dtype="float32")


def bundle():
    return make_lm_bundle("stablelm-12b", FULL, SMOKE,
                          "dense GQA 32/8 decoder LM")
