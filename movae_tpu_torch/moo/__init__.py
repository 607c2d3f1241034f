from movae_tpu_torch.moo.aggregators import (AggregatorConfig, compute_weights,
                                             gradient_similarity, init_state)

__all__ = ["AggregatorConfig", "compute_weights", "gradient_similarity",
           "init_state"]
