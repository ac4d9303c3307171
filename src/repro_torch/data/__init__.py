from repro_torch.data.synthetic import SyntheticLM, cifar_like_batches

__all__ = ["SyntheticLM", "cifar_like_batches"]
