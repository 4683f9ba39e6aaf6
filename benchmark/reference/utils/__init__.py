"""The reference's initial-state pool loader."""
