"""The paper's methodology: power model, simulator, SVR, planning engine."""
