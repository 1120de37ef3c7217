"""olmoe-1b-7b [arXiv:2409.02060]: 16L d2048 16H (kv=16) MoE 64e top-8
with fine-grained experts (d_ff 1024), vocab 50304. Full attention, so
no long_500k shape."""
from repro_torch.configs.lm_common import make_lm_bundle
from repro_torch.models.lm import LMConfig
from repro_torch.nn.moe import MoEConfig

FULL = LMConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv=16,
    head_dim=128, d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_model=2048, d_ff=1024),
    q_chunk=512, logits_bf16=True)

SMOKE = LMConfig(
    name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    head_dim=16, d_ff=32, vocab=503,
    moe=MoEConfig(n_experts=8, top_k=4, d_model=64, d_ff=32),
    compute_dtype="float32")


def bundle():
    return make_lm_bundle("olmoe-1b-7b", FULL, SMOKE,
                          "MoE 64e top-8 fine-grained decoder LM")
