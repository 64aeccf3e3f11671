"""Serving runtime of the port (``repro/runtime``): the batched ``Engine``
with PERKS persistent decode and the Prometheus ``MetricsServer``
(``server.py``), and the batched ``SolverService`` and the
continuous-batching ``AsyncSolverService`` (``solver_service.py``)."""
