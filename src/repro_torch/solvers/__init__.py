"""repro_torch.solvers — the data surface of the reference's solver
modules (datasets and device operators). The deprecated ``run_*`` shims
are not ported (ROADMAP); new code builds a Problem and calls
``repro_torch.exec.execute``."""
