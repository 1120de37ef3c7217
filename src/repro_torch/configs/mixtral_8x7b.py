"""mixtral-8x7b [arXiv:2401.04088]: 32L d4096 32H GQA(kv=8) MoE 8e top-2,
SWA window 4096, vocab 32000. The only assigned LM arch whose long_500k
shape runs (sliding window => O(window) ring-buffer KV cache)."""
from repro_torch.configs.lm_common import make_lm_bundle
from repro_torch.models.lm import LMConfig
from repro_torch.nn.moe import MoEConfig

FULL = LMConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv=8,
    head_dim=128, d_ff=14336, vocab=32000, window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_model=4096, d_ff=14336),
    rope_theta=1e6, q_chunk=512, logits_bf16=True)

SMOKE = LMConfig(
    name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    head_dim=16, d_ff=96, vocab=503, window=8,
    moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=96),
    compute_dtype="float32")


def bundle():
    return make_lm_bundle("mixtral-8x7b", FULL, SMOKE,
                          "MoE 8e top-2, GQA 32/8, SWA-4096 decoder LM")
