from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedules import (cosine_schedule, make_schedule,
                                         wsd_schedule)
