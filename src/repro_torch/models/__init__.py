"""Model configuration and the dense decode stack."""
