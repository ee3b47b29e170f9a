"""Models of the port: the paper's har-mlp, and the decoder LMs of the
serving slice (``layers``, ``transformer``, ``api``: falcon-mamba-7b and
granite-3-8b; the rest of the model zoo comes with ROADMAP.md queue 1 item
14)."""

from repro_torch.models.mlp import MLP_HIDDEN, init_mlp, mlp_accuracy, mlp_apply, mlp_loss

__all__ = ["MLP_HIDDEN", "init_mlp", "mlp_apply", "mlp_loss", "mlp_accuracy"]
