"""Full-scene inference, accuracy metrics and class maps."""
