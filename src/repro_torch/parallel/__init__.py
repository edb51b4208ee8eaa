"""Distribution substrate: logical-axis sharding rules, mesh utilities,
gradient compression."""

from repro_torch.parallel.sharding import (LogicalRules, default_rules,
                                           spec_for, tree_specs,
                                           shardings_for, constrain)
