"""Serving steps of the port (counterpart of ``repro.train``'s serving
half).  The optimizers, the train step and checkpoints come with the
training slice (ROADMAP.md queue 1 item 5(e))."""
from repro_torch.train.serve_step import make_decode_step, make_prefill

__all__ = ["make_decode_step", "make_prefill"]
