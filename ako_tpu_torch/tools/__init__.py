"""Host-side CLI tools: akoenc / akodec, the option registry, the
effort-preset PNG writer, and rate control (rate.encode_with_ratio), the
counterparts of ako_tpu/tools. PNG files are read through Pillow."""
