"""End-to-end models: the tabletop detector and the table memory."""
