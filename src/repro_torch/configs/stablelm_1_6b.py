"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b]: 24L d2048 32H MHA
(kv=32) d_ff 5632, vocab 100352, head_dim 64."""
from repro_torch.configs.lm_common import make_lm_bundle
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="stablelm-1.6b", n_layers=24, d_model=2048, n_heads=32, n_kv=32,
    head_dim=64, d_ff=5632, vocab=100352,
    q_chunk=512, logits_bf16=True)

SMOKE = LMConfig(
    name="stablelm16-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    head_dim=16, d_ff=128, vocab=503, compute_dtype="float32")


def bundle():
    return make_lm_bundle("stablelm-1.6b", FULL, SMOKE,
                          "dense MHA 32/32 decoder LM")
