"""The plain references that decide a run's ``correct``.

Each configuration names one of these modules (its ``reference`` key).  They
are written in NumPy and plain PyTorch, import nothing of the program under
test (``reservoir_tpu_torch``) and nothing of JAX, and work every checked
output out again from the run's own inputs and its recorded tile order.
"""
