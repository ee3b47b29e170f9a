from repro_torch.kernels.ssm_scan.ops import ssm_scan, ssm_scan_plain

__all__ = ["ssm_scan", "ssm_scan_plain"]
