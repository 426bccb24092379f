"""Distribution: partition rules as DTensor placements, the activation policy."""
