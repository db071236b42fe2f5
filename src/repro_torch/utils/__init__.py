"""Small helpers of the port's LM stack."""
