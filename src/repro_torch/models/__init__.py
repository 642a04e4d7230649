"""The dense GQA decoder and its paged K/V pool."""
