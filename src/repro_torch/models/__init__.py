"""Models of the port: the paper's har-mlp (the model zoo comes with
ROADMAP.md queue 1 item 14)."""

from repro_torch.models.mlp import MLP_HIDDEN, init_mlp, mlp_accuracy, mlp_apply, mlp_loss

__all__ = ["MLP_HIDDEN", "init_mlp", "mlp_apply", "mlp_loss", "mlp_accuracy"]
