"""Action and reward mappings."""
