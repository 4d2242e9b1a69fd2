from rangeldm_tpu_torch.ops.attention import (  # noqa: F401
    FusedAttention, attention_bwd_t_reference, attention_t_reference,
    fused_attention_bwd_t, fused_attention_t,
)
