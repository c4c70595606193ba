"""The ``fit_population`` driver: a stack of candidates on the runs axis,
as ``QuantumModel.fit_population`` runs an epoch (one
``expectation_population_fn`` value and gradient over the stack, the
best-candidate bookkeeping, Adam over the stack, the clamp, the losses
read on the host)."""

import torch

from benchmark.training import Training, compare  # noqa: F401  (this driver's comparison)


class Session(Training):
    population = True

    def program(self, model):
        proto, cfg = self.cell.protocol, self.cell.cfg
        parts = proto.split(self.inputs["knots"].detach(), cfg)
        stack = {n: parts[n].clone().requires_grad_(True) for n in proto.PARAMS}
        pop_fn = model.expectation_population_fn(proto.observable(cfg, model.torch_device))

        def evaluate(_stack):
            return proto.loss(pop_fn(stack)[1])

        def clamp():
            # fit_population's clamp: each stacked tensor that has a constraint
            with torch.no_grad():
                for name, c in model.constraints.items():
                    if name in stack:
                        stack[name].clamp_(c["min"], c["max"])

        return list(stack.values()), evaluate, clamp
