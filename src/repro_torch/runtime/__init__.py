"""The fault-tolerant training runtime."""
