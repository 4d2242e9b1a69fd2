from rangeldm_tpu_torch.ops.attention import (  # noqa: F401
    attention_t_reference, fused_attention_t,
)
