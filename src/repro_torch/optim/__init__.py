"""Optimizer of the port: AdamW and int8 error-feedback gradient
compression, plain functions on the port's parameter trees."""
