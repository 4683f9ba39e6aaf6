"""The reference's envs: the batched cursor and arm envs and their
assembly glue."""
