from repro_torch.data.pipeline import (SyntheticLMDataset, host_shard_iterator,
                                       pack_documents)
