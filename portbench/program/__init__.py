"""How each configuration ``architecture`` is built in the program under
test (``deeplearning4j_tpu_torch``), one module per architecture."""
