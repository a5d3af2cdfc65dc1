"""Separator models as ``nn.Module``s."""
