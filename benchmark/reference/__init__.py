"""Plain references of the benchmark's configurations: PyTorch (float64 by
default) and Python only, nothing of ``oscen_tpu_torch`` or of the JAX
package.  Each module's ``make(config, dtype)`` gives an object with
``init_state``, ``from_program``, ``program_view``, ``run_block`` and the
names of the state leaves it compares (``COMPARED``, ``PHASES``)."""
