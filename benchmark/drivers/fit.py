"""The ``fit`` driver: one candidate, the model's own parameters, as
``QuantumModel.fit`` runs an epoch (the expectation through
``expectation_fn``, the loss, backward, Adam, ``check_constraints``, the
loss read on the host)."""

from benchmark.training import Training, compare  # noqa: F401  (this driver's comparison)


class Session(Training):
    def program(self, model):
        proto, cfg = self.cell.protocol, self.cell.cfg
        exp_fn = model.expectation_fn(proto.observable(cfg, model.torch_device))

        def evaluate(_stack):
            # as fit calls it: the model's own parameters
            return proto.loss(exp_fn(dict(model.params))[1])[None]

        return [model.params[n] for n in proto.PARAMS], evaluate, model.check_constraints
