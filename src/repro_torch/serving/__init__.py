"""Meili-planned LM serving: the planner and the engine."""
from repro_torch.serving.planner import plan_serving, ServingPlan
from repro_torch.serving.engine import ServingEngine, Request
