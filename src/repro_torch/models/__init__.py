"""Model substrate of the port: layers, attention, the mamba mixer,
schedules, registry (dense and ssm families)."""

from repro_torch.models.registry import Model, build
