"""Training steps. Only the single-device QLoRA step is ported; the JAX
package's meshes, sharding and tensor-parallel steps are not."""

from .train import make_qlora_train_step, qlora_loss_and_grads

__all__ = ["make_qlora_train_step", "qlora_loss_and_grads"]
