"""The user flows of ``docs/`` as runnable examples of the port.

One module for each tutorial script: ``gate_optimization``,
``state_preparation``, ``afm_preparation``, ``basic_usage``,
``multi_start``, ``noisy_simulation`` and ``large_scale``.  Each defines
its flow's functions at module level, every one taking an explicit
``device``, and a ``main(device="cuda", ci=False)`` that runs the flow:

    python -m pulser_diff_torch.examples.gate_optimization

runs it on the GPU; ``main(device="cpu", ci=True)`` runs it on the CPU at
the CI sizes of the scripts (also selected by ``PDT_DOCS_CI=1``).
Importing a module runs nothing.
"""
