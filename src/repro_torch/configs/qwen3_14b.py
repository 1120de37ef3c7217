"""qwen3-14b [hf:Qwen]: 40L d5120 40H GQA(kv=8) d_ff 17408, qk-norm,
vocab 151936, head_dim 128."""
from repro_torch.configs.lm_common import make_lm_bundle
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv=8,
    head_dim=128, d_ff=17408, vocab=151936, qk_norm=True,
    rope_theta=1e6, q_chunk=512, logits_bf16=True)

SMOKE = LMConfig(
    name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    head_dim=16, d_ff=128, vocab=503, qk_norm=True,
    compute_dtype="float32")


def bundle():
    return make_lm_bundle("qwen3-14b", FULL, SMOKE,
                          "dense GQA 40/8 qk-norm decoder LM")
