from repro_torch.kernels.ssm_scan.ops import (
    ssm_scan,
    ssm_scan_backward_plain,
    ssm_scan_bwd,
    ssm_scan_plain,
)

__all__ = ["ssm_scan", "ssm_scan_backward_plain", "ssm_scan_bwd", "ssm_scan_plain"]
