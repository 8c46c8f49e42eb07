"""Runtime substrates on the port's transport: the ExaHyPE-style task
offloading of paper §5.4 (``offload``) and a heartbeat failure detector
(``heartbeat``).

    from repro_torch.runtime.offload import run_offload

    out = run_offload("continuations")                   # on the card
    print(out["wall"], out["offloaded"])
"""
