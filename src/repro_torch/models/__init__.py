"""The LM substrate: layers and the transformer (decode-serving path)."""
