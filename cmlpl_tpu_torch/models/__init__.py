"""The BaseNet2 model and its building blocks."""
