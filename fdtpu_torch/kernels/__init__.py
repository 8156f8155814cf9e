from fdtpu_torch.kernels.attention import fused_mha, mha_plain
from fdtpu_torch.kernels.blockdiag_attention import blockdiag_mha, blockdiag_mha_plain
from fdtpu_torch.kernels.ffn import ffn_block, ffn_block_plain

__all__ = ["blockdiag_mha", "blockdiag_mha_plain", "ffn_block", "ffn_block_plain", "fused_mha",
           "mha_plain"]
