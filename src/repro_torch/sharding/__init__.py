"""Sharding on torch.distributed (the counterpart of ``repro.sharding``):
the spec rules (``rules``) and expert-parallel MoE over ``all_to_all``
(``expert_parallel``)."""
