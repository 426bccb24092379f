"""AdamW and the int8 error-feedback gradient compression."""
