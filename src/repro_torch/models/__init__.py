"""Every family of the reference's LM zoo — the dense and MoE transformer
(GQA and MLA), the Mamba-2 LM, the whisper encoder–decoder and the zamba2
hybrid, with their layers, attention, MoE and Mamba-2 blocks: serving, the
training loss and the train step."""

from .model import (
    ModelBundle,
    batch_shardings,
    build_model,
    input_specs,
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = ["ModelBundle", "batch_shardings", "build_model", "input_specs", "loss_and_grads",
           "make_prefill_step", "make_serve_step", "make_train_step"]
