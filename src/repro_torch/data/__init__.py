"""repro_torch.data — numpy copies of the JAX package's data layer:
synthetic datasets, the Dirichlet and writer partitions, the bank's
bucketing, its int8 codes, its k-means cluster routing and the training
drivers' batch iterators."""

from repro_torch.data.partition import (dirichlet_partition,
                                        partition_stats, writer_partition)
from repro_torch.data.pipeline import (assign_clusters, assign_tiers,
                                       batch_iterator, bucket_examples,
                                       bucket_num_batches,
                                       client_bucket_examples,
                                       client_cluster_features,
                                       dequantize_stack, kmeans_clusters,
                                       lm_batches, make_client_datasets,
                                       pad_client_data,
                                       quantize_stack, stack_client_arrays,
                                       train_test_split,
                                       validate_client_data)
from repro_torch.data.synthetic import (synthetic_image_classification,
                                        synthetic_lm_tokens)
