"""The Flex-plorer: precision design-space exploration over the bit-exact simulator."""
