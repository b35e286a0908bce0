"""LoRA state and slot paging."""
