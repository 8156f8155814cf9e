from fdtpu_torch.kernels.blockdiag_attention import blockdiag_mha, blockdiag_mha_plain

__all__ = ["blockdiag_mha", "blockdiag_mha_plain"]
