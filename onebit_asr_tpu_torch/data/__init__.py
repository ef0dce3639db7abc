"""Text side of serving: model ids -> text."""
