"""The port's command-line tools, run as modules: ``python -m
reservoir_tpu_torch.tools.loadgen`` (:mod:`.loadgen`, the open-loop traffic
harness) and ``python -m reservoir_tpu_torch.tools.serve_knob_sweep``
(:mod:`.serve_knob_sweep`, the offline serving-knob sweep), which drive the
port's ``ReservoirService`` on the card unless ``--device cpu`` is given;
``python -m reservoir_tpu_torch.tools.reservoir_lint`` (:mod:`.reservoir_lint`,
the AST invariant pass, standard library only); and ``python -m
reservoir_tpu_torch.tools.block_sweep`` (:mod:`.block_sweep`, the tile
kernels' launch-geometry sweep on the card)."""
