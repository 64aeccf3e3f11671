"""repro_torch — the PyTorch/CUDA port of the PERKS reproduction, for one
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``repro`` is the reference and this package imports none of
it. The stencil, conjugate-gradient and Krylov paths::

    from repro_torch import StencilProblem, plan, execute
    from repro_torch.kernels.common import get_spec

    problem = StencilProblem(x, get_spec("2d5pt"), n_steps=100)  # on "cuda"
    y = execute(problem, plan(problem))

    from repro_torch import CGProblem
    from repro_torch.solvers.cg import load_dataset, load_matrix, load_sell

    data, cols = load_dataset("poisson2d_small")              # on "cuda"
    problem = CGProblem.from_ell(data, cols, b, 100,
                                 matrix=load_matrix("poisson2d_small"))
    x, rr = execute(problem, plan(problem))
    op = load_sell("fem_band_8k")                             # SELL-C-σ
    problem = CGProblem.from_matvec(op.matvec, b, 100, matrix=op.matrix)
    x, rr = execute(problem, plan(problem))                   # loop tiers

    from repro_torch import BiCGStabProblem, GMRESProblem

    data, cols = load_dataset("convdiff_small")               # nonsymmetric
    matrix = load_matrix("convdiff_small")
    problem = BiCGStabProblem.from_ell(data, cols, b, 100, matrix=matrix)
    x, rr = execute(problem, plan(problem))
    problem = GMRESProblem.from_ell(data, cols, b, 4, m=16, matrix=matrix)
    x, rr = execute(problem, plan(problem))                   # 4 cycles

The ML serving path::

    from repro_torch import Engine, Model, SSMScanProblem
    from repro_torch.configs import get_config
    from repro_torch.runtime.server import Request

    model = Model(get_config("qwen2-0.5b"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    engine = Engine(model, params)
    engine.submit(Request(prompt, max_new_tokens=32))
    tokens, stats = engine.run_batch()      # DecodeAttentionProblem inside
    problem = SSMScanProblem(x, dt, a, b, c, d, chunk=128)
    y = execute(problem, plan(problem))     # resident: ssm_scan

Batching, serving and observability::

    from repro_torch import (AsyncConfig, AsyncSolverService, BatchedProblem,
                             ServiceConfig, SolverService)
    from repro_torch import obs

    batch = BatchedProblem.from_instances([p1, p2, p3])   # same batch_key
    xs = batch.split(execute(batch, plan(batch)))   # one launch a step
    svc = SolverService(ServiceConfig(max_batch=8))
    rid = svc.submit(problem)
    results = svc.drain()                   # {request_id: RequestResult}
    eng = AsyncSolverService(AsyncConfig(max_batch=8))  # continuous batching
    results = eng.serve([(0.0, p1), (0.002, p2)])   # lanes admitted mid-solve
    with obs.use_tracer(obs.Tracer()) as tr:
        execute(problem, plan(problem))     # spans, events
    best = autotune(problem, top_k=4, ledger=obs.DriftLedger("l.json")).best

Entry points run on the card unless the caller passes ``device="cpu"``,
where the plain torch versions of the kernels run.
"""
from repro_torch.exec import (BatchedProblem, BiCGStabProblem, CGProblem,
                              DecodeAttentionProblem, GMRESProblem, Plan,
                              SSMScanProblem, StencilProblem, autotune,
                              execute, execute_sequential, plan)
from repro_torch.models.lm import Model
from repro_torch.runtime.server import Engine, start_metrics_server
from repro_torch.runtime.solver_service import (AsyncConfig, AsyncSolverService,
                                                ServiceConfig,
                                                ServiceOverloaded,
                                                SolverService)

__all__ = ["AsyncConfig", "AsyncSolverService", "BatchedProblem",
           "BiCGStabProblem", "CGProblem",
           "DecodeAttentionProblem", "Engine", "GMRESProblem", "Model",
           "Plan", "SSMScanProblem", "ServiceConfig", "ServiceOverloaded",
           "SolverService",
           "StencilProblem", "autotune", "execute", "execute_sequential",
           "plan", "start_metrics_server"]
