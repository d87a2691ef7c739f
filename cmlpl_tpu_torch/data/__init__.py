"""Host data: scene loading, preparation, patch geometry and splits."""
