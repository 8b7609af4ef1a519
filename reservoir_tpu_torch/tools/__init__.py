"""The serving plane's load tools for the port, run as modules:
``python -m reservoir_tpu_torch.tools.loadgen`` (:mod:`.loadgen`, the
open-loop traffic harness) and ``python -m
reservoir_tpu_torch.tools.serve_knob_sweep`` (:mod:`.serve_knob_sweep`, the
offline serving-knob sweep).  They drive the port's ``ReservoirService``,
on the card unless ``--device cpu`` is given."""
