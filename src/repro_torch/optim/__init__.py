"""AdamW with an f32 master copy, and int8 error-feedback compression."""
