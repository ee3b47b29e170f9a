"""Models of the port: the paper's har-mlp, and the model zoo it serves
(``layers``; ``transformer``, the decoder-only LMs; ``whisper``, the
encoder-decoder; ``api``, the facade over both)."""

from repro_torch.models.mlp import MLP_HIDDEN, init_mlp, mlp_accuracy, mlp_apply, mlp_loss

__all__ = ["MLP_HIDDEN", "init_mlp", "mlp_apply", "mlp_loss", "mlp_accuracy"]
