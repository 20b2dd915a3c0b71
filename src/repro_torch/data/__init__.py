"""repro_torch.data — numpy copies of the JAX package's data layer:
synthetic datasets, the Dirichlet partition, and the bank's bucketing."""

from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import (assign_tiers, bucket_examples,
                                       bucket_num_batches,
                                       client_bucket_examples,
                                       make_client_datasets, pad_client_data,
                                       stack_client_arrays, train_test_split,
                                       validate_client_data)
from repro_torch.data.synthetic import (synthetic_image_classification,
                                        synthetic_lm_tokens)
