"""Model substrate of the port: layers, attention, schedules, registry
(dense family)."""

from repro_torch.models.registry import Model, build
